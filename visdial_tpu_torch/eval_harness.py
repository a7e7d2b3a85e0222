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

The scoring goes through parallel/train_step.py's eval factories, as the
JAX harness's goes through its jitted ones.  On the card a streamed batch
replays the factories' graphs, then the harness's own rank graphs
(_RANKED, _COMBINED: the JAX harness's _rank_fn, _cand_rank_fn and
_combine_fn); the resident eval replays one graph of a batch's whole body
for every batch (no CUDA graph loops, so it is not one graph over the
split as JAX's lax.scan is one program).  Either way the graphs read the
params from the factories' one shared copy, loaded once a call, and disc's
option table where its graph wrote it.  The factories' eager functions
(impl="plain") run batch by batch.

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
rank's shard, passed down as an argument (parallel/mesh.py::VocabShard),
and the shard's reductions over the model group run inside the graphs.
The ranks of a model group hold the same dialogs, so they capture and
replay the same signatures (the gen buckets' capacities are the split's);
the data gather and the metrics' broadcast stay outside the graphs.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from .config import Config
from .data.dataset import VisDialSplit, Vocabulary
from .data.loader import EvalLoader

from .models.model import _impl, batch_to_device
from .parallel.graph import (CAPTURING, Graphed, InferenceGraphed,
                             read_in_place)
from .parallel.mesh import Mesh, slice_dialogs
from .parallel.train_step import (make_disc_table_eval_fns, make_eval_fn,
                                  make_gen_bucket_eval_fns)
from .utils import trace
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
    moves with no events.

    The main thread may capture a graph (a factory's first batch) while the
    staging thread uploads the next.  torch hands its streams out from
    pools, round robin, so the copy stream may be the one being captured:
    an upload holds graph.CAPTURING, which every capture holds, and so
    never runs during one.  The copy stream is taken once a device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.copy = _copy_stream(torch.cuda.device(device).idx)

    def upload(self, arrays: dict):
        """(tensors on the device, the copy's event or None); called from
        the staging thread."""
        host = batch_to_device(arrays, "cpu")
        if not self.cuda:
            return host, None
        with CAPTURING, torch.cuda.stream(self.copy):
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


@functools.lru_cache(maxsize=None)
def _copy_stream(index: int) -> torch.cuda.Stream:
    """The streamed eval's copy stream on card `index`, one for the process
    (high priority: not a stream of the default-priority pool that
    torch.cuda.graph and the NCCL groups draw from)."""
    return torch.cuda.Stream(index, priority=-1)


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


@functools.lru_cache(maxsize=16)
def _cached_eval_fn(cfg: Config, mesh: Mesh | None, impl: str | None):
    """One make_eval_fn per (cfg, mesh, impl), as the JAX harness's
    _cached_* factories: repeated evaluate_split calls without explicit
    functions (finetune's NDCG, the evaluate CLI, sweeps) replay their
    graphs instead of capturing anew."""
    return make_eval_fn(cfg, mesh, impl)


@functools.lru_cache(maxsize=16)
def _cached_disc_table_fns(cfg: Config, mesh: Mesh | None, impl: str | None):
    return make_disc_table_eval_fns(cfg, mesh, impl)


@functools.lru_cache(maxsize=16)
def _cached_gen_bucket_fns(cfg: Config, mesh: Mesh | None, impl: str | None):
    return make_gen_bucket_eval_fns(cfg, mesh, impl)


def _graphed(fns: tuple) -> bool:
    """Whether the factories' functions are graphs that share a params copy
    (InferenceGraphed with a Held); else (impl="plain", a caller's own
    functions) every piece of a batch runs eagerly."""
    return all(isinstance(f, Graphed) and f.held is not None for f in fns)


def _ranked(scores, gt_ind, ties: str, collect_rankings: bool) -> tuple:
    """One batch's outputs: its ranks and, with collect_rankings, every
    candidate's ranking (the JAX harness's _rank_fn and _cand_rank_fn)."""
    ranks = ranks_from_scores(scores, gt_ind, ties)
    if collect_rankings:
        return ranks, candidate_rankings(scores)
    return (ranks,)


def _combined(rows: list, scats: list, gt_ind, K: int, ties: str,
              collect_rankings: bool) -> tuple:
    """The gen buckets' row scores scattered into one batch's (B, R, K)
    scores (a (B*R*K + 1,) buffer whose last slot takes the padded rows),
    then _ranked (the JAX harness's _combine_fn, then its rank functions)."""
    B, R = gt_ind.shape
    brk = B * R * K
    flat = torch.zeros(brk + 1, dtype=torch.float32, device=gt_ind.device)
    for scat, row in zip(scats, rows):
        flat[scat] = row.float()
    return _ranked(flat[:brk].reshape(B, R, K), gt_ind, ties, collect_rankings)


# the harness's own jitted helpers, as the JAX harness's module-level
# _rank_fn / _cand_rank_fn / _combine_fn: one graph a signature each
_RANKED = InferenceGraphed(_ranked)
_COMBINED = InferenceGraphed(_combined)


def _batch_outputs(path: str, fns: tuple, p, table, tables, dev: dict,
                   widths: list, vocab: Vocabulary, K: int, ties: str,
                   collect_rankings: bool, graphed: bool) -> tuple:
    """One batch's _ranked outputs from its device tensors `dev` through
    the factories' functions, with the params `p` (and the option tables):

      direct   fns (eval_fn,): model_scores of the batch's option tokens;
      table    fns (table_fn, score_fn): the encoder and a gather from
               `table`, the (M, H) option table;
      buckets  fns (encoder_fn, row_score_fn): the encoder, every active
               bucket's rows scored at its width (the batch's rows{i} /
               ridx{i} / scat{i}, the <START>/<END> rows built from
               tables["opt_list"] / tables["opt_len"]), then _combined.

    graphed: fns are the factories' graphs, replayed one by one, and the
    ranks (and the gen scatter) the harness's _RANKED / _COMBINED graphs;
    else every piece runs eagerly (the eager functions, or the factories'
    bodies inside the resident eval's batch graph)."""
    rank = _RANKED if graphed else _ranked
    gt = dev["gt_ind"]
    if path == "direct":
        return rank(fns[0](p, dev), gt, ties, collect_rankings)
    if path == "table":
        return rank(fns[1](p, table, dev), gt, ties, collect_rankings)
    encoder_fn, row_fn = fns
    joint = encoder_fn(p, {k: dev[k] for k in _ENCODER_KEYS if k in dev},
                       **({"clone": False} if graphed else {}))
    rows = [row_fn(p, joint, tables["opt_list"], tables["opt_len"],
                   dev[f"rows{i}"], dev[f"ridx{i}"], width, vocab.start,
                   vocab.end) for i, width in enumerate(widths)]
    scats = [dev[f"scat{i}"] for i in range(len(widths))]
    return (_COMBINED if graphed else _combined)(rows, scats, gt, K, ties,
                                                 collect_rankings)


def _params(fns: tuple, params):
    """The params the factories' functions read: with graphs, their shared
    device copy (Held), loaded here once a call so that no batch copies
    them again; else the params as given."""
    return fns[0].held.load(params) if _graphed(fns) else params


def _device_tables(data: VisDialSplit, cfg: Config, device) -> dict:
    """The split's params-free option tables on the device (opt_list, and
    for gen opt_len), uploaded once and kept on the split object; the
    graphs read them in place (graph.py::read_in_place), so a graph
    captured over one split's tables never copies or overwrites them, and
    another split's capture their own."""
    cache = data.__dict__.setdefault("_torch_device_tables", {})
    key = (cfg.decoder, str(device))
    if key not in cache:
        cache[key] = read_in_place(batch_to_device(_option_tables(data, cfg),
                                                   device))
    return cache[key]


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


class _ResidentGraph(NamedTuple):
    graph: InferenceGraphed
    outs: tuple                   # (nb, bs, R) ranks [, (nb, bs, R, K)]
    index: torch.Tensor           # (nb,): batch i's index, a 0-dim view each


class _ResidentEvalBase:
    """The split's eval batches resident on the device
    (eval_harness.py::_ResidentEvalBase): assembled once into (nb, bs, ...)
    stacks and uploaded once (the integer fields as int64 and the image
    features as float32, as batch_to_device ships them; `nbytes` counts
    exactly that), with the keep / keep_dump masks of the metrics and the
    rankings dump.  `run` scores every batch on the device with no host
    sync: ranks go into one preallocated (nb, bs, R) device tensor (and the
    (nb, bs, R, K) candidate rankings with collect_rankings), read back
    once.

    With graphed factories (the JAX resident eval's one-dispatch lax.scan)
    one batch's body is one CUDA graph, captured once per variant
    (collect_rankings, the factories): it takes the batch index as a 0-dim
    device tensor, gathers that batch from the stacks in place (no copy of
    them), scores it and writes its outputs into the preallocated buffers;
    `run` replays it nb times with no sync between, then reads back once.
    The body reads the params from the factories' shared copy (loaded once
    a run) and disc's option table where the table graph wrote it, in the
    table graph's memory pool.  Subclasses give the batch keys, the bucket
    plan and the scoring path."""

    extra_keys: tuple = ()
    path = ""

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
        with trace.span("build.host"):
            self.plan = self._plan(data, batch_size)
            loader = EvalLoader(data, vocab, _float32(cfg),
                                batch_size=batch_size, option_tokens=False)
            host, keep, dump = [], [], []
            for b in loader:
                host.append(_batch_arrays(b, _ENCODER_KEYS + self.extra_keys,
                                          self.plan, cfg.num_options, self.sl))
                dv = b.dialog_valid.astype(bool)[:, None]
                keep.append(dv & b.round_valid.astype(bool))
                dump.append(dv & b.round_scoreable.astype(bool))
            self.keep = np.stack(keep)                  # (nb, bs, R)
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
        self.tables = _device_tables(data, cfg, self.device)
        if self.device.type == "cuda":   # the upload counts as build time
            torch.cuda.synchronize(self.device)
        self.build_seconds = time.time() - t0
        # runs per (impl, collect_rankings): the first of each pays the
        # kernel build and first launches (graphed: the warm-up and the
        # capture), and is tagged cold_compile
        self.runs: dict = {}
        self.graphs: dict = {}       # (collect_rankings, fns) -> _ResidentGraph

    def _plan(self, data, batch_size):
        return None

    def run(self, params, fns: tuple, collect_rankings: bool):
        """(ranks (nb, bs, R), candidate rankings (nb, bs, R, K) or None) as
        numpy arrays; over a data axis each rank scores its slices, then one
        gather and one readback."""
        graphed = _graphed(fns)
        with trace.span("eval.table"):
            p = _params(fns, params)
            table = None
            if self.path == "table":
                table = fns[0](p, self.tables["opt_list"],
                               **({"clone": False} if graphed else {}))
        with trace.span("eval.batches"):
            if graphed:
                ranks, cand = self._replay(p, table, fns, collect_rankings)
            else:
                ranks, cand = self._loop(p, table, fns, collect_rankings)
        with trace.span("eval.readback"):
            if self.sl is not None:
                ranks = _gather_stacked(ranks, self.mesh)
                cand = (_gather_stacked(cand, self.mesh) if collect_rankings
                        else None)
            return (ranks.cpu().numpy(),
                    cand.cpu().numpy() if collect_rankings else None)

    def _loop(self, p, table, fns, collect_rankings):
        """The eager functions, batch by batch from Python."""
        nb = len(self.keep)
        ranks = cand = None
        for i in range(nb):
            got = _batch_outputs(
                self.path, fns, p, table, self.tables,
                {k: v[i] for k, v in self.stacks.items()}, self._widths(),
                self.vocab, self.cfg.num_options, self.ties, collect_rankings,
                graphed=False)
            if ranks is None:
                ranks = got[0].new_empty((nb, *got[0].shape))
            ranks[i] = got[0]
            if collect_rankings:
                if cand is None:
                    cand = got[1].new_empty((nb, *got[1].shape))
                cand[i] = got[1]
        return ranks, cand

    def _replay(self, p, table, fns, collect_rankings):
        """The batch graph replayed nb times (the class docstring)."""
        key = (collect_rankings, fns)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._batch_graph(fns, collect_rankings)
        for i in entry.index:
            entry.graph(p, i, table)
        return entry.outs if collect_rankings else (entry.outs[0], None)

    def _batch_graph(self, fns, collect_rankings) -> _ResidentGraph:
        """One batch's body over the factories' eager functions, as a graph
        that shares their params copy: the batch at a 0-dim device index
        gathered from the stacks in place, its outputs written into (nb,
        ...) buffers allocated here, outside the graph's pool.  The body
        holds no reference to this object."""
        gt = self.stacks["gt_ind"]                        # (nb, bs, R)
        outs = (torch.empty(gt.shape, device=self.device, dtype=(
            torch.float32 if self.ties == "mean" else torch.int32)),)
        if collect_rankings:
            outs += (torch.empty((*gt.shape, self.cfg.num_options),
                                 dtype=torch.int32, device=self.device),)
        stacks, tables, widths = self.stacks, self.tables, self._widths()
        path, vocab, K, ties = self.path, self.vocab, self.cfg.num_options, \
            self.ties
        bodies = tuple(f.fn for f in fns)

        def body(p, i, table):
            at = i.view(1)
            dev = {k: v.index_select(0, at)[0] for k, v in stacks.items()}
            got = _batch_outputs(path, bodies, p, table, tables, dev, widths,
                                 vocab, K, ties, collect_rankings,
                                 graphed=False)
            for out, x in zip(outs, got):
                out.index_copy_(0, at, x[None])

        return _ResidentGraph(InferenceGraphed(body, held=fns[0].held), outs,
                              torch.arange(len(gt), device=self.device))

    def _widths(self) -> list:
        return self.plan.active if self.plan is not None else []

    @property
    def captures(self) -> int:
        """Batch graphs captured over this cache's life."""
        return sum(e.graph.captures for e in self.graphs.values())


class _ResidentDiscEval(_ResidentEvalBase):
    """Disc: opt_list is uploaded once; each call rebuilds the option table
    (it depends on the params) through table_fn, then every batch is the
    encoder, a table gather and the ranks."""

    extra_keys = ("opt_inds", "gt_ind")
    path = "table"


class _ResidentGenEval(_ResidentEvalBase):
    """Gen: the bucket index tensors of every batch (_GenBucketPlan) are
    part of the stacks, and opt_list / opt_len are uploaded once, so a warm
    call ships nothing to the device."""

    extra_keys = ("gt_ind",)
    path = "buckets"

    def _plan(self, data, batch_size):
        return _GenBucketPlan.cached(data, batch_size)


def _resident_eval(res: _ResidentEvalBase, params, fns: tuple, data,
                   cfg: Config, impl: str, return_ranks: bool,
                   collect_rankings: bool):
    """evaluate_split's resident branch; t0 comes before the option table's
    build, as in the JAX harness (the streaming t0 comes after it)."""
    if res.device.type == "cuda":
        torch.cuda.synchronize(res.device)
    t0 = time.time()
    with torch.inference_mode():
        ranks, cand = res.run(params, fns, collect_rankings)
    elapsed = time.time() - t0                  # both readbacks included
    with trace.span("eval.metrics"):
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
                   device, *, eval_fn=None, table_fns=None, gen_fns=None,
                   batch_size: int | None = None,
                   ties: str = "optimistic", impl: str | None = None,
                   return_ranks: bool = False, collect_rankings: bool = False,
                   resident: bool = False, resident_max_bytes: int = 4 << 30,
                   mesh: Mesh | None = None):
    """Score every candidate of every round of `data` and return the
    retrieval metrics plus 'evals_per_sec' (rounds ranked per second) and
    'eval_seconds'.

    The scoring functions are the JAX harness's (eval_harness.py::
    evaluate_split): disc takes the option-table path through table_fns
    (make_disc_table_eval_fns), gen with cfg.gen_eval_bucketed the
    length-bucketed path through gen_fns (make_gen_bucket_eval_fns), else
    the direct path through eval_fn (make_eval_fn; the same scores).  None
    uses the factories cached per (cfg, mesh, impl); pass the factories'
    returns to reuse them across evals, False (or an explicit eval_fn) to
    force the direct path, which streams.  With graphed factories (on the
    card, over a mesh too) each streamed batch replays their graphs and the
    harness's rank graphs, and the resident eval replays one batch graph nb
    times (_ResidentEvalBase); eager ones (impl="plain", a caller's own
    functions) run batch by batch.

    resident=True keeps the split's batches on the device (cached on the
    split per class, batch size, cfg, ties, byte cap, device and mesh) and
    adds 'resident_cache_seconds', 'resident_cache_bytes' and, on the first run
    of each (impl, collect_rankings) variant, 'cold_compile'; its
    evals_per_sec includes the disc option table's build, the streaming
    one excludes it, as in the JAX harness.  It streams when the stacks
    exceed resident_max_bytes or on the direct path (no resident_* keys
    then).

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
    out = _evaluate(params, data, vocab, cfg, device, eval_fn, table_fns,
                    gen_fns, batch_size, ties, impl, return_ranks,
                    collect_rankings, resident, resident_max_bytes, mesh)
    if isinstance(out, tuple):
        return (_rank0_metrics(out[0], mesh), *out[1:])
    return _rank0_metrics(out, mesh)


def _evaluate(params, data, vocab, cfg, device, eval_fn, table_fns, gen_fns,
              batch_size, ties, impl, return_ranks, collect_rankings,
              resident, resident_max_bytes, mesh):
    device = torch.device(device)
    bs = batch_size or cfg.batch_size
    # the JAX harness's choice of path: an explicit eval_fn wins, False
    # forces the direct path
    if (cfg.decoder == "disc" and table_fns is not False
            and (table_fns is not None or eval_fn is None)):
        path, fns = "table", table_fns or _cached_disc_table_fns(cfg, mesh,
                                                                 impl)
    elif (cfg.decoder == "gen" and cfg.gen_eval_bucketed
          and gen_fns is not False
          and (gen_fns is not None or eval_fn is None)):
        path, fns = "buckets", gen_fns or _cached_gen_bucket_fns(cfg, mesh,
                                                                 impl)
    else:
        path, fns = "direct", (eval_fn or _cached_eval_fn(cfg, mesh, impl),)
    if resident and path != "direct" and eval_fn is None:
        cls = _ResidentDiscEval if path == "table" else _ResidentGenEval
        res = cls.cached(data, vocab, cfg, bs, ties, resident_max_bytes,
                         device, mesh)
        if res.ok:
            return _resident_eval(res, params, fns, data, cfg,
                                  impl or _impl(cfg, device), return_ranks,
                                  collect_rankings)

    loader = EvalLoader(data, vocab, _float32(cfg), batch_size=bs,
                        option_tokens=path == "direct")
    keys = _ENCODER_KEYS + ("gt_ind",) + {
        "table": ("opt_inds",), "buckets": (),
        "direct": ("opt",) if cfg.decoder == "disc" else ("opt_in", "opt_out"),
    }[path]
    plan = _GenBucketPlan.cached(data, bs) if path == "buckets" else None
    K = cfg.num_options
    graphed = _graphed(fns)
    with torch.inference_mode():
        p = _params(fns, params)
        tables = (_device_tables(data, cfg, device) if path != "direct"
                  else None)
        table = None
        if path == "table":             # the graph's table is read in place
            table = fns[0](p, tables["opt_list"],
                           **({"clone": False} if graphed else {}))
    widths = plan.active if plan else []

    def step(dev):
        return _batch_outputs(path, fns, p, table, tables, dev, widths, vocab,
                              K, ties, collect_rankings, graphed)
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
            fetched = xfer.readback(step(dev))
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
