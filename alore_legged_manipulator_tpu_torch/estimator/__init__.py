from .icr_ekf import EkfConfig, EkfState, ekf_init, ekf_predict, ekf_update  # noqa: F401
