"""Device operations (kernels, copies, sets) launched per KeySwitch batch in
the traced part."""


def read(r):
    if r.op != "keyswitch" or not r.win.traced_batches:
        return None
    return r.trace.device_ops / r.win.traced_batches
