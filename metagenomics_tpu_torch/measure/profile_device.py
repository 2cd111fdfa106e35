"""Fine-grained profile of the device overlap pipeline on the bench set.

    python -m metagenomics_tpu_torch.measure.profile_device   (needs a card)

Prints, with a synchronize after every stage:
  * link health: H2D / D2H rates (pageable and pinned, 8 MB and 256 MB),
    the card's copy bandwidth and a dispatch round trip;
  * per-stage times of the pipeline's construction (bench.staged_pipeline,
    the constructor's own steps): host pack, upload, setup kernel, probe
    join with its scalar read-back; then the full stream and the native
    replay of it (a warm-up and three runs);
  * device-only runs (pipeline + stream(download=False));
  * the stream's composition: survivors, self pairs, pair multiplicity.
"""

import collections
import json
import time

import numpy as np
import torch

from .. import bench


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_device runs on a CUDA card; none is "
                         "available")
    from .. import native
    device = torch.device("cuda", 0)
    print("card:", bench.card_label(), "|", torch.cuda.get_device_name(0))
    print(json.dumps(bench.link_rates(device), indent=1))

    bench.gen_bench_data()
    ds, cfg = bench.load_dataset()
    n = ds.number_of_unique_reads
    print("unique reads:", n, "lmax:", ds.codes_fwd.shape[1])

    def staged_run(label):
        t0 = time.perf_counter()
        p, stages, _ = bench.staged_pipeline(ds, device)
        t = {name: ms for name, (ms, _) in stages.items()}
        t["init_total_ms"] = 1e3 * (time.perf_counter() - t0)
        t["stream_ms"], res = bench.timed(
            lambda: p.stream(check_cont=False), device)
        counts, r2, meta = res
        t["build_ms"], _ = bench.timed(lambda: native.build_graph_stream(
            ds.lengths, counts, r2, meta, False, cfg.dead_end_length),
            bench.CPU)
        t.update(n_survivors=len(r2), h_total=p.h_total, grand=p.grand)
        print(label, json.dumps(t))
        return counts, r2, meta

    staged_run("warmup")
    for i in range(3):
        counts, r2, meta = staged_run("run%d" % i)

    for i in range(3):
        print("device_only run%d: %.6f s"
              % (i, bench.run_device_only(ds, device)))

    r1 = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    r2 = r2.astype(np.int64)
    print("survivors:", len(r1), "self-pairs r1==r2:", int((r1 == r2).sum()))
    lo = np.minimum(r1, r2)
    hi = np.maximum(r1, r2)
    key = lo.astype(np.uint64) * np.uint64(n + 2) + hi.astype(np.uint64)
    uniq, cnt = np.unique(key, return_counts=True)
    print("pair multiplicity histogram:",
          dict(collections.Counter(cnt.tolist()).most_common(8)))
    print("unique unordered pairs:", len(uniq),
          "vs survivors/2:", len(r1) / 2)
    print("meta orient histogram:",
          dict(collections.Counter((meta & 3).tolist())))


if __name__ == "__main__":
    main()
