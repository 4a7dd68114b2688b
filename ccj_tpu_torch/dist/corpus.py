"""Multi-process streaming corpus folding (PyTorch).

Counterpart of ``ccj_tpu/dist/corpus.py``.  The reference folds exactly one
sequence per process invocation (reference: src/CCJ.cc:67-72).  Here a
corpus is sharded round-robin over N processes, each process folds its
shard in length-bucketed ``fold_many`` chunks on its own device, and
process 0 merges the results through a ``torch.distributed.TCPStore`` it
hosts at ``--coordinator``: a key-value exchange, as the JAX driver's
distributed-runtime store is, with no NCCL or gloo process group.  By
default process i folds on ``cuda:{i % device_count}``, one process per
card where there are enough (several share a card otherwise).

Failure handling: a 10k-sequence corpus run must not abort on one bad
sequence.  A chunk that fails falls back to per-sequence folds with
``retries`` further attempts each, on the same device; sequences that still
fail are reported with ``error`` set instead of aborting the whole run.

    python -m ccj_tpu_torch.dist.corpus corpus.txt out.json \\
        --coordinator HOST:PORT --num-processes N --process-id I [--device cpu]
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import sys
import time

from ..api import bucket_for, fold, fold_many

STORE_PREFIX = "ccj/corpus/"


@dataclasses.dataclass
class CorpusResult:
    index: int                 # position in the input corpus
    seq: str
    structure: str | None
    energy: float | None
    error: str | None = None


def _fold_one(seq: str, retries: int = 2, **kw) -> CorpusResult:
    last = None
    for _ in range(retries + 1):
        try:
            r = fold(seq, **kw)
            return CorpusResult(-1, seq, r.structure, r.energy)
        except Exception as exc:  # noqa: BLE001 — retry, then record
            last = f"{type(exc).__name__}: {exc}"
    return CorpusResult(-1, seq, None, None, error=last)


def fold_shard(seqs, indices, retries: int = 2, batch_limit: int = 8, **kw):
    """Fold a local shard in length-bucketed chunks of ``batch_limit``
    (``api.fold_many``); a chunk that fails falls back to per-sequence
    folds with retries, so one bad sequence cannot sink its chunk.
    ``indices`` are the sequences' corpus positions; ``kw`` goes to
    ``fold_many`` and ``fold`` (``device``, ``dangles``, ...).  Returns the
    results sorted by index."""
    dbg = os.environ.get("CCJ_CORPUS_DEBUG")
    order = sorted(range(len(seqs)), key=lambda i: bucket_for(len(seqs[i])))
    out = []
    for lo in range(0, len(order), batch_limit):
        chunk = order[lo: lo + batch_limit]
        t0 = time.time()
        try:
            rs = fold_many([seqs[i] for i in chunk],
                           batch_limit=batch_limit, **kw)
            if dbg:
                print(f"[corpus] chunk of {len(chunk)}: "
                      f"{time.time() - t0:.2f}s", file=sys.stderr)
            for i, r in zip(chunk, rs):
                out.append(CorpusResult(indices[i], seqs[i], r.structure,
                                        r.energy))
        except Exception as exc:  # noqa: BLE001 — chunk failed: per-seq fallback
            # always log the cause: a systematic failure (code bug, OOM)
            # would otherwise silently degrade EVERY chunk to slow
            # sequential folds with no trace of why
            print(f"[corpus] batch of {len(chunk)} failed "
                  f"({type(exc).__name__}: {exc}); falling back to "
                  f"per-sequence folds", file=sys.stderr)
            for i in chunk:
                r = _fold_one(seqs[i], retries=retries, **kw)
                r.index = indices[i]
                out.append(r)
    return sorted(out, key=lambda r: r.index)


def _open_store(coordinator: str, num_processes: int, process_id: int,
                timeout_ms: int):
    """The merge's key-value store: process 0 hosts it at ``coordinator``
    (HOST:PORT), the others connect to it."""
    import torch.distributed as tdist

    host, port = coordinator.rsplit(":", 1)
    return tdist.TCPStore(host, int(port), world_size=num_processes,
                          is_master=process_id == 0,
                          timeout=datetime.timedelta(milliseconds=timeout_ms),
                          wait_for_workers=False)


def fold_corpus(seqs, retries: int = 2, merge_timeout_ms: int | None = None,
                coordinator: str | None = None, num_processes: int = 1,
                process_id: int = 0, **kw):
    """Fold this process's round-robin shard of ``seqs`` and merge: every
    process returns the full corpus-ordered result list.

    One process (the default) folds everything locally.  With
    ``num_processes`` N > 1, ``process_id`` I folds entries i with
    i % N == I and the shards meet in a ``TCPStore`` at ``coordinator``
    that process 0 hosts; process 0 returns only after every process has
    read every shard, so none loses the store while it reads.

    ``merge_timeout_ms`` bounds every wait on the store (connecting, and
    the fastest process waiting for the slowest).  The default scales with
    the shard size (10 min + 1 min per sequence): shard wall times skew by
    whole fills plus per-sequence retries, so a fixed small timeout would
    kill exactly the long-corpus runs the retry machinery exists for.
    ``kw`` goes to ``fold_shard``.
    """
    nproc, pid = num_processes, process_id
    if not 0 <= pid < nproc:
        raise ValueError(f"process id {pid} outside [0, {nproc})")
    store = None
    if nproc > 1:
        if coordinator is None:
            raise ValueError("several processes need a --coordinator HOST:PORT")
        if merge_timeout_ms is None:
            shard = (len(seqs) + nproc - 1) // nproc
            merge_timeout_ms = 600_000 + 60_000 * shard
        # opened before the fold, so a process that cannot reach process 0
        # fails before it spends the fold
        store = _open_store(coordinator, nproc, pid, merge_timeout_ms)
    mine = [(i, s) for i, s in enumerate(seqs) if i % nproc == pid]
    local = fold_shard([s for _, s in mine], [i for i, _ in mine],
                       retries=retries, **kw)
    if store is None:
        return local

    store.set(f"{STORE_PREFIX}{pid}",
              json.dumps([dataclasses.asdict(r) for r in local]))
    merged = []
    for p in range(nproc):      # get() waits for the key, up to the timeout
        blob = store.get(f"{STORE_PREFIX}{p}")
        merged.extend(CorpusResult(**d) for d in json.loads(blob))
    if store.add(f"{STORE_PREFIX}reads", 1) == nproc:
        store.set(f"{STORE_PREFIX}all-read", "1")
    if pid == 0:                # the host outlives every reader
        store.wait([f"{STORE_PREFIX}all-read"])
    merged.sort(key=lambda r: r.index)
    return merged


def default_device(process_id: int, device: str | None = None):
    """The device process ``process_id`` folds on: ``device`` where given,
    else ``cuda:{process_id % device_count}`` (the counterpart of the JAX
    driver's pin to the process's first local device); raises without
    CUDA."""
    import torch

    from ..api import resolve_device

    if device is None and torch.cuda.is_available():
        device = f"cuda:{process_id % torch.cuda.device_count()}"
    return resolve_device(device)


def main(argv=None):
    """CLI: ``python -m ccj_tpu_torch.dist.corpus corpus.txt out.json
    --coordinator HOST:PORT --num-processes N --process-id I``"""
    import argparse

    import torch

    from ..engine import cuda_ops

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("corpus", help="file with one sequence per line")
    ap.add_argument("out", help="write merged results here (process 0)")
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of the merge store that process 0 hosts")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--dangles", type=int, default=2)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--merge-timeout-ms", type=int, default=None,
                    help="timeout of every wait on the merge store "
                         "(default: 10 min + 1 min per shard sequence)")
    ap.add_argument("--batch-limit", type=int, default=8,
                    help="sequences per length-bucketed fold_many chunk")
    ap.add_argument("--device", default=None,
                    help="where this process folds (default: "
                         "cuda:<process id mod device count>; cpu for the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    dev = default_device(args.process_id, args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)   # the kernel launches on this card
    with open(args.corpus) as fh:
        seqs = [line.strip() for line in fh
                if line.strip() and not line.startswith("#")]
    t0 = time.time()
    res = fold_corpus(seqs, retries=args.retries,
                      merge_timeout_ms=args.merge_timeout_ms,
                      coordinator=args.coordinator,
                      num_processes=args.num_processes,
                      process_id=args.process_id, dangles=args.dangles,
                      batch_limit=args.batch_limit, device=dev)
    # machine-readable fold wall (a process-scaling probe reads it) and the
    # fill kernels' launches this process made (chip_smoke.py reads them)
    print(f"corpus-fold-seconds {time.time() - t0:.3f}", file=sys.stderr)
    print(f"corpus-tt-span-launches {cuda_ops.TT_SPAN_LAUNCHES}", file=sys.stderr)
    print(f"corpus-minplus-launches {cuda_ops.LAUNCHES}", file=sys.stderr)
    print(f"corpus-tt-step-launches {cuda_ops.TT_STEP_LAUNCHES}", file=sys.stderr)
    print(f"corpus-history-launches {cuda_ops.HISTORY_LAUNCHES}", file=sys.stderr)
    print(f"corpus-psplit-launches {cuda_ops.PSPLIT_LAUNCHES}", file=sys.stderr)
    print(f"corpus-stencil-pl-launches {cuda_ops.STENCIL_PL_LAUNCHES}", file=sys.stderr)
    print(f"corpus-stencil-pr-launches {cuda_ops.STENCIL_PR_LAUNCHES}", file=sys.stderr)
    print(f"corpus-assemble-launches {cuda_ops.ASSEMBLE_LAUNCHES}", file=sys.stderr)
    print(f"corpus-store-launches {cuda_ops.STORE_LAUNCHES}", file=sys.stderr)
    print(f"corpus-span-v-launches {cuda_ops.SPAN_V_LAUNCHES}", file=sys.stderr)
    print(f"corpus-span-wbp-launches {cuda_ops.SPAN_WBP_LAUNCHES}", file=sys.stderr)
    print(f"corpus-span-wm-launches {cuda_ops.SPAN_WM_LAUNCHES}", file=sys.stderr)
    print(f"corpus-wx-launches {cuda_ops.WX_LAUNCHES}", file=sys.stderr)
    if args.process_id == 0:
        with open(args.out, "w") as fh:
            json.dump([dataclasses.asdict(r) for r in res], fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
