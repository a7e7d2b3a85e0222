"""Model assembly: init, the training loss, candidate scoring and answer
generation (port of visdial_tpu/models/model.py).

Kernel dispatch follows the device, as models/model.py::_impl follows the
backend: on a CUDA device with cfg.use_pallas the LSTMs and the attention
tail run as the hand-written kernels; otherwise the plain PyTorch versions
run.  There is no fallback from a failed kernel to the plain version.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import Config

from ..utils.params import flatten, unflatten
from .core import StepGenerators, embedding_init, seeded, split_seeds
from .decoders import (decoder_init, disc_loss, disc_option_table, disc_scores,
                       disc_scores_from_table, gen_beam_decode,
                       gen_candidate_scores, gen_decode, gen_loss)
from .encoders import encoder_apply, encoder_init


def model_init(cfg: Config, seed: int | None = None, device="cpu") -> dict:
    """Fresh params (model.py::model_init) from a CPU torch.Generator seeded
    with `seed` (default cfg.seed), moved to `device`.  On the meta device
    only the shapes are made."""
    if cfg.vocab_size <= 1:
        raise ValueError("set Config.vocab_size from the data artifact")
    device = torch.device(device)
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    home = device if device.type == "meta" else torch.device("cpu")
    params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.embed_size, home),
        "encoder": encoder_init(gen, cfg, home),
        "decoder": decoder_init(gen, cfg, home),
    }
    if device != home:
        params = unflatten({k: v.to(device) for k, v in flatten(params).items()})
    return params


def _impl(cfg: Config, device) -> str:
    return ("cuda" if cfg.use_pallas and torch.device(device).type == "cuda"
            else "plain")


def batch_to_device(batch: dict, device) -> dict:
    """numpy batch (Batch.as_dict()) -> tensors on `device`; integer arrays
    become int64 (token ids and row indices)."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def model_loss(params, batch, cfg: Config, *, train: bool = True,
               gen: torch.Generator | None = None,
               impl: str | None = None, denominator=None,
               seed_offset: int = 0, shard=None) -> torch.Tensor:
    """The training loss of either decoder (model.py::model_loss).  `gen` is a CPU
    torch.Generator (the train state's); in train mode two seeds are drawn
    from it, one for the encoder's dropout and one for the decoder's (the
    roles of jax.random.split(rng)), each seeding a generator on the
    batch's device where it is used.  `gen` may instead be the step's
    device generators, seeded already (core.py::StepGenerators: a captured
    step's, parallel/train_step.py).

    cfg.remat checkpoints the encoder (torch.utils.checkpoint, non-reentrant)
    and recomputes it in the backward.  The recomputation makes its
    generator anew from the same seed (with StepGenerators it draws from
    their `recompute` generator, seeded with the encoder's seed), so it
    draws the forward's dropout masks again: checkpoint's
    preserve_rng_state restores only the default generators, never an
    explicit one, so it is not relied on (and off).

    On a data axis (parallel/train_step.py) the batch is this rank's shard
    of the global batch: the mean divides by `denominator`(the shard's
    count), the global batch's count, so the ranks' losses sum to the
    global batch's loss; and both seeds are offset by `seed_offset` (the
    rank's data coordinate), so each data rank draws its own masks.  On a
    model axis `shard` (parallel/mesh.py::Mesh.vocab_shard) names this
    rank's rows of the embedding and columns of the LM head."""
    impl = impl or _impl(cfg, batch["ques"].device)
    joint, dec_gen = _train_encode(params, batch, cfg, train, gen, impl,
                                   seed_offset, shard)
    loss_fn = gen_loss if cfg.decoder == "gen" else disc_loss
    return loss_fn(params["decoder"], params["embed"], joint, batch, cfg,
                   train=train, gen=dec_gen, impl=impl,
                   denominator=denominator, shard=shard)


def _train_encode(params, batch, cfg: Config, train: bool,
                  gen: torch.Generator | None, impl: str,
                  seed_offset: int = 0, shard=None):
    """The encoder of a training loss: (joint (N, H), the decoder's dropout
    generator or None).  Two seeds come from `gen` in train mode, each
    offset by seed_offset; with cfg.remat the encoder is checkpointed and
    recomputed from its seed.  StepGenerators are used as they are, seeded
    already: the forward draws from `encoder` and a recomputation from
    `recompute`, which holds the encoder's seed.  The closure holds the
    seed (or the generators) and `shard` itself, so the recomputation
    reads the forward's vocab shard on whatever thread the autograd engine
    runs it."""
    device = batch["ques"].device
    enc_seed = dec_seed = draws = None
    if isinstance(gen, StepGenerators):
        if cfg.remat and train and gen.recompute is None:
            raise ValueError("cfg.remat: the step's generators need a "
                             "`recompute` generator seeded as `encoder`")
        # the forward's generator, then the recomputation's
        draws = [gen.encoder, gen.recompute] if train else [None, None]
        dec_gen = gen.decoder if train else None
    else:
        if train and gen is not None:
            enc_seed, dec_seed = (s + seed_offset for s in split_seeds(gen))
        dec_gen = seeded(dec_seed, device)

    def encode(enc_params, embed_params):
        return encoder_apply(enc_params, embed_params, batch, cfg,
                             train=train,
                             gen=(seeded(enc_seed, device) if draws is None
                                  else draws.pop(0)),
                             impl=impl, shard=shard)

    if cfg.remat and train:
        joint = checkpoint(encode, params["encoder"], params["embed"],
                           use_reentrant=False, preserve_rng_state=False)
    else:
        joint = encode(params["encoder"], params["embed"])
    return joint, dec_gen


def model_dense_loss(params, batch, cfg: Config, *, train: bool = True,
                     gen: torch.Generator | None = None,
                     impl: str | None = None, denominator=None,
                     seed_offset: int = 0, shard=None) -> torch.Tensor:
    """v1.0 dense-annotation fine-tuning loss of the disc decoder
    (model.py::model_dense_loss): cross-entropy between the softmax of the
    annotated round's 100 candidate scores (disc_scores over the B x K
    dense_opt rows) and the normalized gt_relevance, over the rows with
    dense_valid set and any relevance.  Dropout seeds and remat as in
    model_loss.

    Batch fields beyond the encoder inputs (data/loader.py::DenseLoader):
    dense_opt (B, K, La), dense_round (B,), dense_rel (B, K) raw relevance,
    dense_valid (B,).  denominator, seed_offset and shard as in model_loss
    (the count is of the valid rows)."""
    if cfg.decoder != "disc":
        raise ValueError("dense fine-tuning targets disc scores")
    impl = impl or _impl(cfg, batch["ques"].device)
    joint, dec_gen = _train_encode(params, batch, cfg, train, gen, impl,
                                   seed_offset, shard)
    B = batch["dense_rel"].shape[0]
    joint = joint.reshape(B, cfg.num_rounds, -1)
    joint_sel = joint[torch.arange(B, device=joint.device),
                      batch["dense_round"].long()]                 # (B, H)
    scores = disc_scores(params["decoder"], params["embed"], joint_sel,
                         batch["dense_opt"], cfg, train=train, gen=dec_gen,
                         impl=impl, shard=shard)                   # (B, K)
    rel = batch["dense_rel"].float()
    total = rel.sum(dim=-1, keepdim=True)
    target = rel / total.clamp(min=1e-9)
    ce = -(target * torch.log_softmax(scores, dim=-1)).sum(dim=-1)
    v = batch["dense_valid"].float() * (total[:, 0] > 0).float()
    count = v.sum() if denominator is None else denominator(v.sum())
    return (ce * v).sum() / count.clamp(min=1.0)


def model_scores(params, batch, cfg: Config, *, impl: str | None = None,
                 shard=None):
    """Candidate scores (B, R, K) from the batch's option tokens: opt for
    disc, opt_in / opt_out for gen; on `shard`'s vocab leaves where
    given."""
    impl = impl or _impl(cfg, batch["ques"].device)
    joint = encoder_apply(params["encoder"], params["embed"], batch, cfg,
                          impl=impl, shard=shard)
    N, K = joint.shape[0], cfg.num_options
    if cfg.decoder == "gen":
        scores = gen_candidate_scores(
            params["decoder"], params["embed"], joint,
            batch["opt_in"].reshape(N, K, -1), batch["opt_out"].reshape(N, K, -1),
            cfg, impl=impl, shard=shard)
    else:
        scores = disc_scores(params["decoder"], params["embed"], joint,
                             batch["opt"].reshape(N, K, -1), cfg, impl=impl,
                             shard=shard)
    return scores.reshape(batch["ques"].shape[0], cfg.num_rounds, K)


def model_option_table(params, opt_list, cfg: Config, *,
                       impl: str | None = None, shard=None):
    """Embed the split's deduplicated option list once: (M, La) -> (M, H)."""
    if cfg.decoder != "disc":
        raise ValueError("the option table belongs to the disc decoder")
    impl = impl or _impl(cfg, opt_list.device)
    return disc_option_table(params["decoder"], params["embed"], opt_list,
                             cfg, impl=impl, shard=shard)


def model_scores_with_table(params, batch, table, cfg: Config, *,
                            impl: str | None = None, shard=None):
    """Candidate scores (B, R, K) via the precomputed option table."""
    impl = impl or _impl(cfg, batch["ques"].device)
    joint = encoder_apply(params["encoder"], params["embed"], batch, cfg,
                          impl=impl, shard=shard)
    N, K = joint.shape[0], cfg.num_options
    scores = disc_scores_from_table(joint, table,
                                    batch["opt_inds"].reshape(N, K))
    return scores.reshape(batch["ques"].shape[0], cfg.num_rounds, K)


def model_generate(params, batch, cfg: Config, *, start_token: int,
                   end_token: int, greedy: bool = True,
                   gen: torch.Generator | None = None, temperature: float = 1.0,
                   beam_size: int = 0, impl: str | None = None):
    """Decode an answer for every (dialog, round) of the batch
    (model.py::model_generate): tokens (B, R, La) and summed log-probs
    (B, R).  Gen decoder only.  beam_size > 1 takes beam search, else
    greedy decoding or, with greedy=False, sampling from `gen` (a generator
    on the batch's device).  The encoder follows impl; the token-by-token
    decode is plain PyTorch on either path, as in the JAX package.  The
    params are whole (generate.py decodes a model axis on whole params)."""
    if cfg.decoder != "gen":
        raise ValueError("generation needs the gen decoder")
    impl = impl or _impl(cfg, batch["ques"].device)
    joint = encoder_apply(params["encoder"], params["embed"], batch, cfg,
                          impl=impl)
    if beam_size and beam_size > 1:
        toks, logp = gen_beam_decode(params["decoder"], params["embed"], joint,
                                     cfg, start_token=start_token,
                                     end_token=end_token, beam_size=beam_size)
    else:
        toks, logp = gen_decode(params["decoder"], params["embed"], joint, cfg,
                                start_token=start_token, end_token=end_token,
                                greedy=greedy, gen=gen, temperature=temperature)
    B = batch["ques"].shape[0]
    return toks.reshape(B, cfg.num_rounds, -1), logp.reshape(B, cfg.num_rounds)
