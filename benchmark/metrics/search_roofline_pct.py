"""The search kernel's share of its roofline: the least time for the
traced calls' search work (the frozen count of whichever search kernel
the trace shows, ``counts/``), over that kernel's device time in the
trace.  None where the trace shows no counted search kernel, more than
one, or an instantiation its count does not know."""


def read(r):
    conf = r.cell.config
    least = device = 0.0
    for g in r.segments:
        ops = r.search_ops(g)
        names = {n for n, _, _ in ops}
        choice = g.info.get("choice")
        if len(names) != 1 or choice is None:
            return None
        name = names.pop()
        count = r.count_for(name)
        for n in g.info["sizes"]:
            work = count.work(name, {"frames": n, "dim": conf["dim"],
                                     "num_codebooks": conf["num_codebooks"],
                                     "passes": choice[1]})
            if work is None:
                return None
            least += r.least_seconds(work)
        device += sum(e - s for _, s, e in ops)
    return 100.0 * least / device if device > 0 else None
