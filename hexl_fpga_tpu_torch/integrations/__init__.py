"""HE schemes on top of the port's primitives: CKKS (`ckks`), BGV (`bgv`) and
BFV (`bfv`), the counterparts of `hexl_fpga_tpu/integrations/`."""

from .bfv import BfvContext, DeviceBfvEvaluator  # noqa: F401
