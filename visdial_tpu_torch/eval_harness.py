"""Retrieval evaluation on one device (port of visdial_tpu/eval_harness.py).

disc: the split's deduplicated option list is embedded once per call
(model_option_table); each batch is then an encoder forward plus a table
gather (model_scores_with_table).

gen, bucketed (cfg.gen_eval_bucketed, the default): a candidate scores the
same at any width >= its length + 1, so each batch's candidate rows are cut
into three width buckets (_GenBucketPlan) and scored bucket by bucket, the
<START>/<END> rows built on the device from the split's opt_list
(parallel/train_step.py::gen_rows_score).  gen, direct: the loader expands
every candidate to full width and model_scores scores them.

Two ways to feed the device:

  * streaming (the JAX harness's staged pipeline): a background thread
    (_staged) assembles batch i+1 and copies it to the device on a copy
    stream while the device scores batch i, and batch i-1's ranks come back
    into pinned host memory while batch i computes (_Transfer);
  * resident (_ResidentDiscEval, _ResidentGenEval): the split's batches are
    assembled and uploaded once as (nb, bs, ...) stacks, cached on the split
    object; each call rebuilds only what depends on the params (the disc
    option table) and scores every batch on the device with no host sync,
    then reads the ranks back once.  Over the byte cap it streams.

Either way the scores are ranked on the device, and the ranks of the rounds
with dialog_valid and round_valid set give MRR / R@1 / R@5 / R@10 / mean
rank.  With collect_rankings every candidate is ranked on the device too
(the v1.0 submission rankings) and kept for the rounds with dialog_valid
and round_scoreable set.

Over a mesh (parallel/mesh.py) each data rank scores its contiguous
dialogs of every batch (the resident eval uploads only those slices of its
stacks), and the ranks and candidate rankings are all-gathered over the
data group in split order once, after the last batch; every rank computes
the metrics from them and returns rank 0's dict.  A batch the data axis
does not divide is replicated instead: every rank scores all of it and no
gather runs (JAX's mesh.py::shard_batch policy).  The disc option table is
built whole on every rank; the vocab-dimensioned leaves are read as the
rank's shard (parallel/mesh.py::vocab_parallel).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from .config import Config
from .data.dataset import VisDialSplit, Vocabulary
from .data.loader import EvalLoader

from .models.encoders import encoder_apply
from .models.model import (_impl, batch_to_device, model_option_table,
                           model_scores, model_scores_with_table)
from .parallel.mesh import Mesh, slice_dialogs, vocab_parallel
from .parallel.train_step import gen_rows_score
from .utils.metrics import (candidate_rankings, ranks_from_scores,
                            retrieval_metrics)

# batch fields any encoder reads (eval_harness.py::_ENCODER_BATCH_KEYS)
_ENCODER_KEYS = ("ques", "hist_concat", "hist_flat", "hist_bounds", "facts",
                 "img")
STAGING_THREAD = "visdial-eval-staging"


def _staged(iterable, stage):
    """Yield stage(item) one ahead of consumption (eval_harness.py::_staged):
    a background thread runs the loader and `stage`, at most two staged
    items wait in a bounded queue.  The producer checks a stop flag around
    every put, so a consumer that abandons the generator (an exception
    downstream, or a break) releases the thread and the staged buffers it
    holds instead of leaving it blocked on a full queue.  An exception in
    the loader or in `stage` is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in iterable:
                if not put(stage(item)):
                    return
            put(None)
        except BaseException as e:  # surface in the consumer, don't hang it
            put(e)

    threading.Thread(target=produce, name=STAGING_THREAD, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():  # drop staged leftovers so their buffers free
            q.get_nowait()


class _Transfer:
    """The streaming eval's copies.  On a CUDA device a staged batch goes
    from pinned host memory to the device on a copy stream, and the compute
    stream waits on an event the copy records (record_stream keeps the
    caching allocator from handing a staged block out again while the
    compute stream still reads it); a readback goes into pinned host
    memory with non_blocking, and its event alone is waited on, so reading
    batch i-1's ranks does not wait for batch i.  On the CPU both are plain
    moves with no events."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.copy = torch.cuda.Stream(device)

    def upload(self, arrays: dict):
        """(tensors on the device, the copy's event or None); called from
        the staging thread."""
        host = batch_to_device(arrays, "cpu")
        if not self.cuda:
            return host, None
        with torch.cuda.stream(self.copy):
            dev = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self.copy)
        for v in dev.values():
            v.record_stream(self.compute)
        return dev, done

    def wait(self, done) -> None:
        """Make the compute stream wait for a staged batch's copy."""
        if done is not None:
            self.compute.wait_event(done)

    def readback(self, tensors: list):
        """Start copying `tensors` to the host; (host tensors, event)."""
        if not self.cuda:
            return [t.cpu() for t in tensors], None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self.compute)
        return host, done

    @staticmethod
    def arrays(fetched) -> list[np.ndarray]:
        """Wait for a readback alone and return it as numpy arrays."""
        host, done = fetched
        if done is not None:
            done.synchronize()
        return [h.numpy() for h in host]


class _GenBucketPlan:
    """Length-bucket plan for gen candidate scoring over one split
    (eval_harness.py::_GenBucketPlan).

    Rows go to the narrowest sufficient of the widths {T/3, 2T/3, T}
    (T = La + 1).  A bucket's capacity is its largest per-batch row count
    over the split's batch sequence, rounded up to 128, so every score call
    has one of three fixed shapes; the padded slots are scattered to a
    dumpster slot."""

    def __init__(self, data: VisDialSplit, batch_size: int):
        T_full = int(data.opt_list.shape[1]) + 1   # tokens + <END>
        self.T_full = T_full
        self.widths = sorted({max(2, (T_full + 2) // 3),
                              max(3, (2 * T_full + 2) // 3), T_full})
        n, bs = data.num_dialogs, batch_size
        edges = np.asarray(self.widths)
        caps = np.zeros(len(self.widths), np.int64)
        for s in range(0, n, bs):
            idx = np.arange(s, min(s + bs, n))
            if len(idx) < bs:                                # pad_to repeats
                idx = np.concatenate([idx, np.repeat(idx[-1:], bs - len(idx))])
            lens = data.opt_list_len[data.opt_inds[idx]] + 1
            b = np.searchsorted(edges, lens.reshape(-1))
            caps = np.maximum(caps, np.bincount(b, minlength=len(self.widths)))
        self.caps = [int(-(-c // 128) * 128) for c in caps]
        self.active = [w for w, c in zip(self.widths, self.caps) if c > 0]

    @classmethod
    def cached(cls, data: VisDialSplit, batch_size: int) -> "_GenBucketPlan":
        """The plan of (split, batch size), kept on the split object."""
        cache = data.__dict__.setdefault("_torch_gen_bucket_plans", {})
        key = (batch_size, int(data.opt_list.shape[1]))
        if key not in cache:
            cache[key] = cls(data, batch_size)
        return cache[key]

    def assign(self, opt_len: np.ndarray) -> list[np.ndarray]:
        """Flat row positions per bucket for one batch (opt_len (B, R, K))."""
        need = opt_len.reshape(-1) + 1
        b = np.searchsorted(np.asarray(self.widths), need)
        return [np.flatnonzero(b == i) for i in range(len(self.widths))]

    def arrays(self, opt_inds: np.ndarray, opt_len: np.ndarray,
               K: int) -> dict:
        """One batch's bucket index arrays, for active bucket i: rows{i}
        (rows into opt_list), ridx{i} (rows into the encoder's output) and
        scat{i} (positions in the flat (B*R*K,) scores; padded slots repeat
        row 0 and land in the dumpster slot B*R*K)."""
        brk = opt_inds.size
        flat_rows = opt_inds.reshape(-1)
        out, i = {}, 0
        for width, cap, rows in zip(self.widths, self.caps,
                                    self.assign(opt_len)):
            if cap == 0:
                continue
            pad = cap - len(rows)
            if pad < 0:
                raise RuntimeError(f"gen bucket of width {width} overflows its "
                                   f"capacity {cap} ({len(rows)} rows)")
            rpad = np.pad(rows, (0, pad))
            out[f"rows{i}"] = flat_rows[rpad]
            out[f"ridx{i}"] = rpad // K
            out[f"scat{i}"] = np.concatenate([rows, np.full(pad, brk)])
            i += 1
        return out


def _disc_scorer(params, opt_list, cfg: Config, impl: str):
    """score(dev) -> (B, R, K) disc scores through the option table, which
    is built here (it depends on the params)."""
    table = model_option_table(params, opt_list, cfg, impl=impl)
    return lambda dev: model_scores_with_table(params, dev, table, cfg,
                                               impl=impl)


def _gen_scorer(params, opt_list, opt_len, widths: list, vocab: Vocabulary,
                cfg: Config, impl: str):
    """score(dev) -> (B, R, K) gen scores: the encoder, every active
    bucket's rows scored at its width (the batch's rows{i} / ridx{i} /
    scat{i}) and scattered into a (B*R*K + 1,) buffer whose last slot takes
    the padded rows."""
    R, K = cfg.num_rounds, cfg.num_options

    def score(dev):
        joint = encoder_apply(params["encoder"], params["embed"], dev, cfg,
                              impl=impl)                          # (N, H)
        B = dev["gt_ind"].shape[0]
        brk = B * R * K
        flat = torch.zeros(brk + 1, dtype=torch.float32, device=joint.device)
        for i, width in enumerate(widths):
            flat[dev[f"scat{i}"]] = gen_rows_score(
                params, joint, opt_list, opt_len, dev[f"rows{i}"],
                dev[f"ridx{i}"], width, vocab.start, vocab.end, cfg,
                impl=impl).float()
        return flat[:brk].reshape(B, R, K)

    return score


def _batch_arrays(batch, keys: tuple, plan: _GenBucketPlan | None,
                  K: int, sl: tuple[int, int] | None = None) -> dict:
    """What the device needs of one loader batch (of its dialogs [lo, hi)
    with sl): its `keys`, plus the gen bucket index arrays under a plan."""
    d = batch.as_dict()
    out = {k: d[k] for k in keys if k in d}
    if sl is not None:
        out = slice_dialogs(out, *sl)
    if plan is not None:
        opts = {"opt_inds": batch.opt_inds, "opt_len": batch.opt_len}
        if sl is not None:
            opts = slice_dialogs(opts, *sl)
        out.update(plan.arrays(opts["opt_inds"], opts["opt_len"], K))
    return out


def _data_slice(mesh: Mesh | None, batch_size: int):
    """This data rank's dialogs of a batch (Mesh.dialog_slice), or None."""
    return None if mesh is None else mesh.dialog_slice(batch_size)


def _gather_stacked(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(nb, bs / data, ...) per data rank -> (nb, bs, ...), the ranks'
    dialogs in split order."""
    g = mesh.gather_data(t.to(mesh.device)).movedim(0, 1)  # (nb, data, n, ...)
    return g.reshape(g.shape[0], -1, *g.shape[3:])


def _rank0_metrics(metrics: dict, mesh: Mesh | None) -> dict:
    """Rank 0's metrics on every rank (the timings differ by rank)."""
    if mesh is None or mesh.world == 1 or not torch.distributed.is_initialized():
        return metrics
    box = [metrics]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def _option_tables(data: VisDialSplit, cfg: Config) -> dict:
    """The split's params-free device tables: opt_list, and for gen
    opt_len."""
    if cfg.decoder == "disc":
        return {"opt_list": data.opt_list}
    return {"opt_list": data.opt_list, "opt_len": data.opt_list_len}


def _float32(cfg: Config) -> Config:
    # batches are assembled in float32; the encoder casts on the device
    return cfg.replace(compute_dtype="float32")


class _ResidentEvalBase:
    """The split's eval batches resident on the device
    (eval_harness.py::_ResidentEvalBase): assembled once into (nb, bs, ...)
    stacks and uploaded once (the integer fields as int64 and the image
    features as float32, as batch_to_device ships them; `nbytes` counts
    exactly that), with the keep / keep_dump masks of the metrics and the
    rankings dump.  `run` scores every batch on the device with no host
    sync: ranks go into one preallocated (nb, bs, R) device tensor (and the
    (nb, bs, R, K) candidate rankings with collect_rankings), read back
    once.  Subclasses give the batch keys, the bucket plan and the
    scorer."""

    extra_keys: tuple = ()

    @classmethod
    def cached(cls, data, vocab, cfg, batch_size, ties, max_bytes, device,
               mesh: Mesh | None = None):
        cache = data.__dict__.setdefault("_torch_resident_eval", {})
        key = (cls.__name__, batch_size, cfg, ties, max_bytes, str(device),
               mesh)
        if key not in cache:
            cache[key] = cls(data, vocab, cfg, batch_size, ties, max_bytes,
                             device, mesh)
        return cache[key]

    def __init__(self, data: VisDialSplit, vocab: Vocabulary, cfg: Config,
                 batch_size: int, ties: str, max_bytes: int, device,
                 mesh: Mesh | None = None):
        t0 = time.time()
        self.vocab, self.cfg, self.ties = vocab, cfg, ties
        self.device = torch.device(device)
        self.mesh, self.sl = mesh, _data_slice(mesh, batch_size)
        self.plan = self._plan(data, batch_size)
        loader = EvalLoader(data, vocab, _float32(cfg), batch_size=batch_size,
                            option_tokens=False)
        host, keep, dump = [], [], []
        for b in loader:
            host.append(_batch_arrays(b, _ENCODER_KEYS + self.extra_keys,
                                      self.plan, cfg.num_options, self.sl))
            dv = b.dialog_valid.astype(bool)[:, None]
            keep.append(dv & b.round_valid.astype(bool))
            dump.append(dv & b.round_scoreable.astype(bool))
        self.keep = np.stack(keep)                      # (nb, bs, R)
        self.keep_dump = np.stack(dump)
        stacks = batch_to_device({k: np.stack([h[k] for h in host])
                                  for k in host[0]}, "cpu")
        tables = batch_to_device(_option_tables(data, cfg), "cpu")
        self.nbytes = sum(t.nbytes for t in (*stacks.values(),
                                             *tables.values()))
        self.ok = self.nbytes <= max_bytes
        if not self.ok:
            return
        self.stacks = {k: v.to(self.device) for k, v in stacks.items()}
        self.tables = {k: v.to(self.device) for k, v in tables.items()}
        if self.device.type == "cuda":   # the upload counts as build time
            torch.cuda.synchronize(self.device)
        self.build_seconds = time.time() - t0
        # runs per (impl, collect_rankings): the first of each pays the
        # kernel build and first launches, and is tagged cold_compile
        self.runs: dict = {}

    def _plan(self, data, batch_size):
        return None

    def _scorer(self, params, impl: str):
        raise NotImplementedError

    def run(self, params, impl: str, collect_rankings: bool):
        """(ranks (nb, bs, R), candidate rankings (nb, bs, R, K) or None) as
        numpy arrays; over a data axis each rank scores its slices, then one
        gather and one readback."""
        score = self._scorer(params, impl)
        nb = len(self.keep)
        ranks = cand = None
        for i in range(nb):
            dev = {k: v[i] for k, v in self.stacks.items()}
            scores = score(dev)
            r = ranks_from_scores(scores, dev["gt_ind"], self.ties)
            if ranks is None:
                ranks = r.new_empty((nb, *r.shape))
            ranks[i] = r
            if collect_rankings:
                c = candidate_rankings(scores)
                if cand is None:
                    cand = c.new_empty((nb, *c.shape))
                cand[i] = c
        if self.sl is not None:
            ranks = _gather_stacked(ranks, self.mesh)
            cand = _gather_stacked(cand, self.mesh) if collect_rankings else None
        return (ranks.cpu().numpy(),
                cand.cpu().numpy() if collect_rankings else None)


class _ResidentDiscEval(_ResidentEvalBase):
    """Disc: opt_list is uploaded once; each call rebuilds the option table
    (it depends on the params), then every batch is the encoder, a table
    gather and the ranks."""

    extra_keys = ("opt_inds", "gt_ind")

    def _scorer(self, params, impl):
        return _disc_scorer(params, self.tables["opt_list"], self.cfg, impl)


class _ResidentGenEval(_ResidentEvalBase):
    """Gen: the bucket index tensors of every batch (_GenBucketPlan) are
    part of the stacks, and opt_list / opt_len are uploaded once, so a warm
    call ships nothing to the device."""

    extra_keys = ("gt_ind",)

    def _plan(self, data, batch_size):
        return _GenBucketPlan.cached(data, batch_size)

    def _scorer(self, params, impl):
        return _gen_scorer(params, self.tables["opt_list"],
                           self.tables["opt_len"], self.plan.active,
                           self.vocab, self.cfg, impl)


def _resident_eval(res: _ResidentEvalBase, params, data: VisDialSplit,
                   cfg: Config, impl: str, return_ranks: bool,
                   collect_rankings: bool):
    """evaluate_split's resident branch; t0 comes before the option table's
    build, as in the JAX harness (the streaming t0 comes after it)."""
    if res.device.type == "cuda":
        torch.cuda.synchronize(res.device)
    t0 = time.time()
    with torch.inference_mode():
        ranks, cand = res.run(params, impl, collect_rankings)
    elapsed = time.time() - t0                  # both readbacks included
    kept = ranks[res.keep]
    metrics = retrieval_metrics(kept)
    metrics["evals_per_sec"] = int(res.keep.sum()) / max(elapsed, 1e-9)
    metrics["eval_seconds"] = elapsed
    metrics["resident_cache_seconds"] = res.build_seconds
    metrics["resident_cache_bytes"] = res.nbytes
    variant = (impl, collect_rankings)
    res.runs[variant] = res.runs.get(variant, 0) + 1
    if res.runs[variant] == 1:
        metrics["cold_compile"] = True
    extra = (kept,) if return_ranks else ()
    if collect_rankings:
        cand = np.where(res.keep_dump[..., None], cand, 0).astype(np.int32)
        extra += (cand.reshape(-1, cfg.num_rounds,
                               cfg.num_options)[:data.num_dialogs],)
    return (metrics, *extra) if extra else metrics


def evaluate_split(params, data: VisDialSplit, vocab: Vocabulary, cfg: Config,
                   device, *, batch_size: int | None = None,
                   ties: str = "optimistic", impl: str | None = None,
                   return_ranks: bool = False, collect_rankings: bool = False,
                   resident: bool = False, resident_max_bytes: int = 4 << 30,
                   mesh: Mesh | None = None):
    """Score every candidate of every round of `data` and return the
    retrieval metrics plus 'evals_per_sec' (rounds ranked per second) and
    'eval_seconds'.  gen takes the bucketed path when
    cfg.gen_eval_bucketed, else the direct one (the same scores).

    resident=True keeps the split's batches on the device (cached on the
    split per class, batch size, cfg, ties, byte cap, device and mesh) and
    adds 'resident_cache_seconds', 'resident_cache_bytes' and, on the first run
    of each (impl, collect_rankings) variant, 'cold_compile'; its
    evals_per_sec includes the disc option table's build, the streaming
    one excludes it, as in the JAX harness.  It streams when the stacks
    exceed resident_max_bytes or when gen is unbucketed (no resident_*
    keys then).

    With return_ranks the return is (metrics, ranks): the gt rank of every
    ranked round, in loader order.  With collect_rankings it is (metrics,
    cand_ranks) (eval_harness.py::evaluate_split): cand_ranks
    (num_dialogs, R, K) int32 holds candidate_rankings of every round that
    is scoreable (a full candidate list, with or without a ground truth:
    the v1.0 test split's rounds have none), zeros elsewhere.  With both,
    (metrics, ranks, cand_ranks).

    With a mesh every rank must call, with the params it holds (the vocab
    leaves its shard); each returns the same metrics (rank 0's) and the
    whole split's ranks and rankings."""
    shard = None if mesh is None else mesh.vocab_shard(cfg.vocab_size)
    with vocab_parallel(shard):
        out = _evaluate(params, data, vocab, cfg, device, batch_size, ties,
                        impl, return_ranks, collect_rankings, resident,
                        resident_max_bytes, mesh)
    if isinstance(out, tuple):
        return (_rank0_metrics(out[0], mesh), *out[1:])
    return _rank0_metrics(out, mesh)


def _evaluate(params, data, vocab, cfg, device, batch_size, ties, impl,
              return_ranks, collect_rankings, resident, resident_max_bytes,
              mesh):
    device = torch.device(device)
    impl = impl or _impl(cfg, device)
    direct = cfg.decoder == "gen" and not cfg.gen_eval_bucketed
    bs = batch_size or cfg.batch_size
    if resident and not direct:
        cls = _ResidentDiscEval if cfg.decoder == "disc" else _ResidentGenEval
        res = cls.cached(data, vocab, cfg, bs, ties, resident_max_bytes,
                         device, mesh)
        if res.ok:
            return _resident_eval(res, params, data, cfg, impl, return_ranks,
                                  collect_rankings)

    loader = EvalLoader(data, vocab, _float32(cfg), batch_size=bs,
                        option_tokens=direct)
    keys = _ENCODER_KEYS + ("gt_ind",)
    plan = None
    K = cfg.num_options
    with torch.inference_mode():
        if direct:
            keys += ("opt_in", "opt_out")
            score = lambda dev: model_scores(params, dev, cfg, impl=impl)  # noqa: E731
        else:
            tables = batch_to_device(_option_tables(data, cfg), device)
            if cfg.decoder == "disc":
                keys += ("opt_inds",)
                score = _disc_scorer(params, tables["opt_list"], cfg, impl)
            else:
                plan = _GenBucketPlan.cached(data, bs)
                score = _gen_scorer(params, tables["opt_list"],
                                    tables["opt_len"], plan.active, vocab,
                                    cfg, impl)
    xfer = _Transfer(device)
    sl = _data_slice(mesh, bs)
    all_ranks, held = [], []
    cand_out = (np.zeros((data.num_dialogs, cfg.num_rounds, K), np.int32)
                if collect_rankings else None)

    def consume(got, masks, start) -> int:
        dv, round_valid, round_scoreable = masks
        keep = dv & round_valid
        all_ranks.append(got[0][keep])
        if collect_rankings:
            dump = dv & round_scoreable
            n = min(start + len(got[1]), data.num_dialogs) - start
            cand_out[start:start + n] = np.where(dump[:n, :, None],
                                                 got[1][:n], 0)
        return int(keep.sum())

    def read(pending) -> int:
        """One batch's readback, consumed now, or over a data axis held
        (its rank slices and masks only) until the gather."""
        fetched, masks, start = pending
        got = xfer.arrays(fetched)
        if sl is None:
            return consume(got, masks, start)
        held.append((got, masks, start))
        return 0

    def stage(batch):
        masks = (batch.dialog_valid.astype(bool)[:, None],
                 batch.round_valid.astype(bool),
                 batch.round_scoreable.astype(bool))
        return xfer.upload(_batch_arrays(batch, keys, plan, K, sl)), masks

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    n_rounds = 0
    pending = None
    # three stages deep: the staging thread assembles and copies batch i+1
    # while the device scores batch i, and batch i-1's ranks are read back
    # while batch i computes
    with torch.inference_mode():
        for bi, ((dev, copied), masks) in enumerate(_staged(loader, stage)):
            xfer.wait(copied)
            scores = score(dev)
            outs = [ranks_from_scores(scores, dev["gt_ind"], ties)]
            if collect_rankings:
                outs.append(candidate_rankings(scores))
            fetched = xfer.readback(outs)
            if pending is not None:
                n_rounds += read(pending)
            pending = (fetched, masks, bi * bs)
        if pending is not None:
            n_rounds += read(pending)
        if held:                # one gather of every batch's slices
            gathered = zip(*(
                _gather_stacked(torch.from_numpy(np.stack(f)), mesh).cpu().numpy()
                for f in zip(*(got for got, _, _ in held))))
            for got, (_, masks, start) in zip(gathered, held):
                n_rounds += consume(got, masks, start)
    elapsed = time.time() - t0
    ranks = np.concatenate(all_ranks)
    metrics = retrieval_metrics(ranks)
    metrics["evals_per_sec"] = n_rounds / max(elapsed, 1e-9)
    metrics["eval_seconds"] = elapsed
    extra = ((ranks,) if return_ranks else ()) + (
        (cand_out,) if collect_rankings else ())
    return (metrics, *extra) if extra else metrics
