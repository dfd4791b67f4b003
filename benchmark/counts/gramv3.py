"""Count of the Gram-table search kernel (K3), ``csrc/gramv3.cu``:
``gramv3_kernel<I8, NC, M, TIMED>``.

Per frame and pass, one root row and M rows for each later codebook, each
the sum of nc table rows of 256, counted at the f32 add rate.  bf16 sums
each row in codebook order, so every candidate adds all nc rows; int8
sums are exact in any order, so at step t the rows s >= t that every
candidate shares are added once: M t + (nc - t) rows a step, and nc for
the root row.  The bytes are XC, the initial indexes, the root scores, the
table and the output.  Frozen from the H100 bring-up's bound
(``_gramv3_bound``)."""

import re

KERNEL = "gramv3_kernel<"
CS = 256


def work(op_name: str, call: dict):
    m = re.search(r"gramv3_kernel<([^>]*)>", op_name)
    if m is None:
        return None
    args = [a.strip().lower() for a in m.group(1).split(",")]
    if len(args) < 3 or args[0] not in ("true", "false", "1", "0"):
        return None
    int8 = args[0] in ("true", "1")
    try:
        M = int(args[2])
    except ValueError:
        return None
    B, nc, passes = call["frames"], call["num_codebooks"], call["passes"]
    K = nc * CS
    if int8:
        rows = nc + sum(M * t + nc - t for t in range(1, nc))
    else:
        rows = (1 + (nc - 1) * M) * nc
    nbytes = B * K * 4 + B * nc * 4 + B * 4 + K * K * (1 if int8 else 2) + B * nc * 4
    return {"ops": {"f32": B * passes * rows * CS}, "bytes": nbytes}
