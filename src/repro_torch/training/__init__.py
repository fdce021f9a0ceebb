"""Training (``repro/training``): AdamW with the global-norm clip, int8
gradient compression over per-device gradients, and the train-step
factory, on PyTorch tensors with ``torch.autograd``."""
from .optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    compressed_psum,
)
from .train import TrainStepConfig, make_train_step, value_and_grad
