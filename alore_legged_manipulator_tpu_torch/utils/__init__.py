from .angles import normalize_angle, unwrap_to, smooth_yaw_sequence  # noqa: F401
