"""simumax_tpu_torch — the PyTorch/CUDA port of the analytical LLM
training simulator, for one NVIDIA H100.

Beside the JAX package (the reference, left untouched) this package
carries its own copy of the jax-free analytical model (``perf.py``,
``core/``, ``models/``), a PyTorch reference Llama (``torchref/``)
whose flash attention runs hand-written CUDA kernels
(``csrc/flash_attn.cu``), and the self-calibration loop
(``calibration/``, ``bench.py``) that measures a real training step on
the card and calibrates the estimate against it.
"""

from simumax_tpu_torch.version import __version__
from simumax_tpu_torch.core.config import ModelConfig, StrategyConfig, SystemConfig
from simumax_tpu_torch.perf import PerfLLM

__all__ = [
    "__version__",
    "ModelConfig",
    "StrategyConfig",
    "SystemConfig",
    "PerfLLM",
]
