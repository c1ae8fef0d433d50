"""The port's twins of the repo's user-facing examples (`examples/*.py`).

Each module has `main(argv=None)`, which parses its example's flags plus
`--device {cuda,cpu}` (default `cuda`: it raises without a card), prints
the lines its example prints and returns a dict of those quantities.
Each runs as `python -m alore_legged_manipulator_tpu_torch.examples.<name>`:

* `mission_validation`: random missions over a walled world, visit orders
  from greedy and branch-and-bound with JPS path costs (host work);
* `planner_sim`: one plan by the `PlanManager`, then the NMPC + ICR-EKF
  closed loop on the noisy kinematic plant;
* `arrangement_mission`: the multi-object rearrangement mission, on the
  kinematic or the contact plant;
* `train_and_deploy_highlevel`: PPO training (or a restored checkpoint),
  the fixed-command tracking eval and the bus mission with the policy in
  the loop;
* the throughput benches `bench_backend`, `bench_closed_loop`,
  `bench_frontend`, `bench_mapping`, `bench_mission_fleet`,
  `bench_mission_legs` and `bench_physics_env`: each reads its example's
  environment variables with the same defaults, prints its lines (with
  the device and its power limit) and computes each line in a function
  of explicit sizes, eager, timed with a synchronize after the warm-up.
"""
