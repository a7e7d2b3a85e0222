"""Weights made on the device from the seed, in the port's parameter layout.

The layout (the port's checkpoint tree, nested dicts with each stacked
LSTM a {"layers": [{"w", "b"}, ...]} list): embed/table (V, E); per LSTM
layer w (in + H, 4H) for [x; h] and one bias (4H,), gates i, f, g, o; each
linear w (in, out) and b (out,).  Every matrix is drawn uniform(-0.08,
0.08) in one call on the device from a generator seeded by the run's seed;
biases are zero with the LSTM forget gate's at 1.0, and the embedding's pad
row is zero (the initialisation the source's train.lua uses).

The embedding's and the decoders' leaves are laid out here, the encoder's
by its family module (encoders/<family>.py::weight_shapes), so a
configuration whose family has a module has a layout.
"""

from __future__ import annotations

import torch

SCALE = 0.08


def lstm_shapes(prefix: str, in_dim: int, config: dict) -> dict:
    """{path: shape} of a stacked LSTM with input width in_dim."""
    H, out = config["rnn_hidden_size"], {}
    for i in range(config["num_layers"]):
        out[f"{prefix}/layers/{i}/w"] = ((in_dim if i == 0 else H) + H, 4 * H)
        out[f"{prefix}/layers/{i}/b"] = (4 * H,)
    return out


def linear_shapes(prefix: str, i: int, o: int) -> dict:
    return {f"{prefix}/w": (i, o), f"{prefix}/b": (o,)}


def shapes(config: dict, family) -> dict:
    """{path: shape} of every leaf, paths as "encoder/ques_lstm/layers/0/w":
    the embedding, then the encoder's leaves (its family module's
    weight_shapes, encoders/), then the decoder's."""
    E, H, V = (config["embed_size"], config["rnn_hidden_size"],
               config["vocab_size"])
    out = {"embed/table": (V, E), **family.weight_shapes(config)}
    if config["decoder"] == "gen":
        out.update(lstm_shapes("decoder/lm_lstm", E, config))
        out.update(linear_shapes("decoder/out_proj", H, V))
    else:
        out.update(lstm_shapes("decoder/opt_lstm", E, config))
    return out


def nest(flat: dict) -> dict:
    """{path: tensor} -> the nested tree ("layers" become lists)."""
    tree: dict = {}
    for path, t in flat.items():
        node, keys = tree, path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(tree)


def make(config: dict, family, seed: int, device) -> dict:
    """{path: float32 tensor on device}: the matrices from one uniform draw
    of a generator on `device` seeded with `seed`, in shapes' order, the
    biases set."""
    sizes = shapes(config, family)
    mats = [p for p, s in sizes.items() if len(s) == 2]
    total = sum(sizes[p][0] * sizes[p][1] for p in mats)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(total, device=device).uniform_(-SCALE, SCALE,
                                                     generator=gen)
    flat, at = {}, 0
    for p in mats:
        n = sizes[p][0] * sizes[p][1]
        flat[p] = buf[at:at + n].view(sizes[p]).clone()
        at += n
    flat["embed/table"][0].zero_()
    H = config["rnn_hidden_size"]
    for p, s in sizes.items():
        if len(s) == 1:
            b = torch.zeros(s, device=device)
            if "_lstm/" in p:
                b[H:2 * H] = 1.0        # forget gate
            flat[p] = b
    return {p: flat[p] for p in sizes}


def flatten(tree, prefix: str = "") -> dict:
    """The nested tree -> {path: tensor} (nest's inverse)."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out
