"""Card-clock milliseconds from one batch body's end to the next body's
start, averaged over the gaps in the window's untraced part (the port's
`TorchExecutor.timeline` events): how long the compute stream waits for the
host's staging."""


def read(r):
    g = r.win.body_gaps_ms
    return sum(g) / len(g) if g else None
