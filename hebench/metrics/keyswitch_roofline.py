"""Percent: the least time the card could take for the KeySwitch work of
the traced part (work/keyswitch.py against peaks.json) over the device time
of all its kernels, copies left out."""


def read(r):
    return r.roofline("keyswitch")
