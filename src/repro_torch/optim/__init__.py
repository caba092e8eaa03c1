from .adamw import adamw_init, adamw_update
from .nesterov import nesterov_init, nesterov_update
from .schedule import cosine_schedule

__all__ = ["adamw_init", "adamw_update", "cosine_schedule", "nesterov_init",
           "nesterov_update"]
