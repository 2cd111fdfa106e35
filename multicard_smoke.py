#!/usr/bin/env python3
"""The sharded engine across every visible card (two or more).

Run from the root of a checkout on a machine with several NVIDIA cards:

    python3 multicard_smoke.py

After chip_smoke.py's setup phase (the kernels and the native library
built from the sources), the port's CLI runs chip_smoke.py's nine golden
configs two ways under the `auto` engine, which must resolve to sharded:

  1. one process per card, joined into one NCCL group through
     MGTPU_COORDINATOR / MGTPU_NUM_PROCESSES / MGTPU_PROCESS_ID (the
     script starts them; a process that finds MGTPU_PROCESS_ID set is a
     rank): each rank holds one shard of the default (dp, ix) split and
     writes every artifact itself;
  2. one process holding one shard on each card.

Every run's 12 artifacts and normalized log must equal golden/out/<cfg>/,
and it must launch both window-hash kernels once for each shard its
process holds.  Prints one line a config and rank; exits non-zero on any
failure, and when fewer than two cards are visible.
"""

import os
import subprocess
import sys
import tempfile
import time

import chip_smoke as cs


def golden_configs(window_hash, root, label, shards):
    """The nine golden configs under auto, each in root/<cfg>; each must
    run sharded and launch both kernels `shards` times."""
    for name in cs.GOLDEN_CONFIGS:
        asm, counts = cs.golden_run(window_hash, name,
                                    os.path.join(root, name), "auto", label)
        if asm.engine != "sharded" or \
                counts != dict.fromkeys(cs.KERNELS, shards):
            raise SystemExit("%s: %s ran %s with launches %s"
                             % (label, name, asm.engine, counts))


def rank_main(window_hash):
    """One rank: joins the NCCL group (before the CLI runs, so that their
    logs hold no join line), then runs the golden configs over it."""
    import torch.distributed as dist
    from metagenomics_tpu_torch.parallel import initialize_distributed
    initialize_distributed(log=cs.log, device="cuda")
    rank = os.environ["MGTPU_PROCESS_ID"]
    label = "rank %s/%s" % (rank, os.environ["MGTPU_NUM_PROCESSES"])
    with tempfile.TemporaryDirectory(prefix="multicard_") as tmp:
        golden_configs(window_hash, tmp, label, 1)
    backend = dist.get_backend()
    dist.destroy_process_group()
    if backend != "nccl":
        raise SystemExit("%s joined a %s group, not nccl" % (label, backend))
    cs.log("RANK_OK %s" % rank)


def main():
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        sys.stderr.write("multicard_smoke: needs two or more CUDA devices\n")
        return 2
    sys.path[:0] = [cs.REPO, os.path.join(cs.REPO, "tests")]
    from metagenomics_tpu_torch.ops import window_hash
    if "MGTPU_PROCESS_ID" in os.environ:
        rank_main(window_hash)
        return 0

    n = torch.cuda.device_count()
    cs.setup(torch, window_hash)
    cs.log("== %d NCCL ranks, one a card" % n)
    port = cs.free_port()
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)],
        env=dict(os.environ, MGTPU_COORDINATOR="127.0.0.1:%d" % port,
                 MGTPU_NUM_PROCESSES=str(n), MGTPU_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        sys.stdout.write(out)
        if p.returncode != 0 or "RANK_OK %d" % r not in out:
            raise SystemExit("rank %d failed (rc %d)" % (r, p.returncode))
    cs.log("  %d ranks: %.2f s" % (n, time.time() - t0))

    cs.log("== one process, one shard a card")
    with tempfile.TemporaryDirectory(prefix="multicard_") as tmp:
        golden_configs(window_hash, tmp, "in process", n)
    cs.log("MULTICARD OK: %d x %s" % (n, cs.card_label()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
