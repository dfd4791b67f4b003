"""The whole encode call's share of the card's bf16 peak, by the work the
configuration's shapes fix: 2 dim nc cs operations a frame, the
``to_logits`` product that scores every codeword once, whatever search
runs.  Frames of the traced calls over the traced stretches' seconds."""


def read(r):
    conf = r.cell.config
    frames, wall = r.sum("frames"), r.wall_s
    if frames == 0 or wall <= 0:
        return None
    flops = 2.0 * conf["dim"] * conf["num_codebooks"] * conf["codebook_size"] * frames
    return 100.0 * flops / wall / r.peaks["ops_per_s"]["bf16"]
