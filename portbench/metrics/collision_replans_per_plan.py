"""Mean over every plan of the window of the attempts of the collision
loop (`BackendResult.replans`: 1 when the first plan is clear, up to
the configuration's max_collision_replans)."""


def read(rec):
    return rec.get("replans")
