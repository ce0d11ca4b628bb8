"""keyswitch.graph_share.device's reading, in the cells that drive the API:
the share of dispatch_batch's bodies that replayed a captured CUDA graph."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "hebench_metrics_keyswitch_graph_share",
    os.path.join(os.path.dirname(__file__), "keyswitch.graph_share.device.py"))
_device = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_device)
read = _device.read
