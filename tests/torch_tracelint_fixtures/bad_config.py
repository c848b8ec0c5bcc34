"""config-mutation fixture: process-wide settings outside __init__.py."""
import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("high")
torch.cuda.set_sync_debug_mode("error")
os.environ["CUDA_LAUNCH_BLOCKING"] = "1"
os.environ.setdefault("TORCH_SHOW_CPP_STACKTRACES", "1")
torch.use_deterministic_algorithms(True)
