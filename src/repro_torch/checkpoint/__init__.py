from .checkpointer import AsyncCheckpointer, latest, restore, save

__all__ = ["save", "restore", "latest", "AsyncCheckpointer"]
