"""Count of the sequential-beam search kernel (K2, and B4 as its v1
instantiation), ``csrc/seqbeam.cu``: ``seqbeam_kernel<ET, M, V1, ...>``
with ET 0 (f32 E), 1 (bf16 E) or 2 (int8 E).

Per frame and pass, the rescore is one root row (bf16) and M rows for each
later codebook (int8 for int8 E, else bf16) against the 256 codewords of
dim D, two operations a product term; the bytes are the frames and
indexes in, the indexes out, and the tables (bf16 codebooks, their bf16
Gram blocks, and for int8 E the int8 codebooks and their scales).  Frozen
from the H100 bring-up's bound (``_seqbeam_bound``), so that it does not
move with the program."""

import re

KERNEL = "seqbeam_kernel<"
E_TYPES = {0: "f32", 1: "bf16", 2: "int8"}
CS = 256


def _args(op_name: str):
    m = re.search(r"seqbeam_kernel<([^>]*)>", op_name)
    if m is None:
        return None
    out = []
    for a in m.group(1).split(","):
        a = a.strip().lower().replace("(int)", "").replace("(bool)", "")
        out.append({"true": 1, "false": 0}.get(a, a))
    try:
        return [int(a) for a in out]
    except ValueError:
        return None


def work(op_name: str, call: dict):
    args = _args(op_name)
    if args is None or len(args) < 3 or args[0] not in E_TYPES:
        return None
    e_dtype, M = E_TYPES[args[0]], args[1]
    B, D, nc, passes = call["frames"], call["dim"], call["num_codebooks"], call["passes"]
    root = B * passes * 2 * D * CS
    beam = B * passes * (nc - 1) * M * 2 * D * CS
    ops = {"bf16": root + (0 if e_dtype == "int8" else beam)}
    if e_dtype == "int8":
        ops["int8"] = beam
    nbytes = B * D * 4 + 2 * B * nc * 4 + nc * CS * D * 2 + nc * CS * CS * 2
    if e_dtype == "int8":
        nbytes += nc * CS * D + nc * 4
    return {"ops": ops, "bytes": nbytes}
