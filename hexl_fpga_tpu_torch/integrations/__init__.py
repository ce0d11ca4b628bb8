"""HE schemes on top of the port's primitives: CKKS (`ckks`) and BGV (`bgv`),
the counterparts of `hexl_fpga_tpu/integrations/`."""
