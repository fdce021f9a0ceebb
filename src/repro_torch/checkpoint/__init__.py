from .manager import (
    CheckpointManager,
    CheckpointMismatchError,
    restore_onto,
)
