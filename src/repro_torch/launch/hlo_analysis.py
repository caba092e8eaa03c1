"""The counterpart by name of ``repro/launch/hlo_analysis.py``.  The port
compiles no HLO to parse: the collectives a step calls are recorded under
a fake process group, and the roofline uses the H100's constants, in
``launch/comm_analysis.py``.  This module gives the reference's two
entry points under their old module name."""
from repro_torch.launch.comm_analysis import (collective_stats,  # noqa: F401
                                              roofline_terms)
