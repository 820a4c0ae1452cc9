"""k1_roofline.x4rep: k1_roofline (K1's share of its roofline, in %) in the
cells that split a batch over replicas, whose rate is search_qps.x4rep: the
same reading, summed over every card's K1 calls."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_dyn_k1_roofline", Path(__file__).with_name("k1_roofline.py"))
_k1 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_k1)
read = _k1.read
