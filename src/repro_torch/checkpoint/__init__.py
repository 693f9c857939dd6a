from .checkpoint import latest_step, restore, save, save_async, wait_pending

__all__ = ["latest_step", "restore", "save", "save_async", "wait_pending"]
