"""The counterpart by name of ``repro/analysis/jaxlint.py``.  The port
traces nothing with JAX: its capture-discipline pass (CUDA graphs and
``torch.compile``, rules TORCH101-TORCH105) is ``analysis/torchlint.py``,
whose ``run`` this module gives under the reference's module name."""
from .torchlint import run  # noqa: F401
