from .profiles import (ProfileKeyError, backend_config_from_profiles,
                       frontend_config_from_profiles, load_profile,
                       ltv_config_from_profiles, nmpc_config_from_profile,
                       occupancy_config_from_profile, reference_profile_paths)

__all__ = [
    "ProfileKeyError", "load_profile", "reference_profile_paths",
    "backend_config_from_profiles", "frontend_config_from_profiles",
    "nmpc_config_from_profile", "ltv_config_from_profiles",
    "occupancy_config_from_profile",
]
