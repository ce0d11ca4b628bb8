"""Device operations (kernels, copies, sets) launched per CKKS op (a rotation
or a matrix-vector product) in the traced part."""


def read(r):
    if r.op != "ckks" or not r.win.traced_ops:
        return None
    return r.trace.device_ops / r.win.traced_ops
