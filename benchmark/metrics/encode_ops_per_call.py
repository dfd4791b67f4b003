"""Device operations (kernels, copies, fills) an encode call launches."""


def read(r):
    calls = r.sum("calls")
    return sum(len(g.ops) for g in r.segments) / calls if calls else None
