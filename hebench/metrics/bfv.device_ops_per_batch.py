"""Device operations (kernels, copies, sets) launched per BFV multiply batch
in the traced part."""


def read(r):
    if r.op != "bfv_multiply" or not r.win.traced_batches:
        return None
    return r.trace.device_ops / r.win.traced_batches
