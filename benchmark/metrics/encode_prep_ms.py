"""Device milliseconds an encode call spends outside the search kernel:
the logits-argmax init, the tables, the packing and any copy."""


def read(r):
    calls = r.sum("calls")
    if calls == 0:
        return None
    other = sum(sum(e - s for _, s, e in g.ops) - sum(e - s for _, s, e in r.search_ops(g))
                for g in r.segments)
    return 1e3 * other / calls
