from .adamw import adamw_init, adamw_update, adamw_update_
from .nesterov import nesterov_init, nesterov_update
from .schedule import cosine_schedule

__all__ = ["adamw_init", "adamw_update", "adamw_update_", "cosine_schedule",
           "nesterov_init", "nesterov_update"]
