"""Weights made on the device from the seed, in the port's parameter layout.

The layout (the port's checkpoint tree, nested dicts with each stacked
LSTM a {"layers": [{"w", "b"}, ...]} list): embed/table (V, E); per LSTM
layer w (in + H, 4H) for [x; h] and one bias (4H,), gates i, f, g, o; each
linear w (in, out) and b (out,).  Every matrix is drawn uniform(-0.08,
0.08) in one call on the device from a generator seeded by the run's seed;
biases are zero with the LSTM forget gate's at 1.0, and the embedding's pad
row is zero (the initialisation the source's train.lua uses).
"""

from __future__ import annotations

import torch

SCALE = 0.08


def shapes(config: dict) -> dict:
    """{path: shape} of every leaf, paths as "encoder/ques_lstm/layers/0/w".
    Covers the MN encoder with the fc7 image and either decoder."""
    E, H, V = (config["embed_size"], config["rnn_hidden_size"],
               config["vocab_size"])
    F, L = config["img_feat_size"], config["num_layers"]
    if not config["encoder"].startswith("mn-"):
        raise ValueError(f"no weight layout for {config['encoder']!r}")
    out = {"embed/table": (V, E)}

    def lstm(prefix, in_dim, layers):
        for i in range(layers):
            out[f"{prefix}/layers/{i}/w"] = ((in_dim if i == 0 else H) + H, 4 * H)
            out[f"{prefix}/layers/{i}/b"] = (4 * H,)

    def linear(prefix, i, o):
        out[f"{prefix}/w"] = (i, o)
        out[f"{prefix}/b"] = (o,)

    lstm("encoder/ques_lstm", E, L)
    lstm("encoder/fact_lstm", E, L)
    if "-im" in config["encoder"]:
        linear("encoder/img_proj", F, H)
        linear("encoder/query_fusion", 2 * H, H)
    linear("encoder/fusion", 2 * H, H)
    if config["decoder"] == "gen":
        lstm("decoder/lm_lstm", E, L)
        linear("decoder/out_proj", H, V)
    else:
        lstm("decoder/opt_lstm", E, L)
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


def make(config: dict, seed: int, device) -> dict:
    """{path: float32 tensor on device}: the matrices from one uniform draw
    of a generator on `device` seeded with `seed`, the biases set."""
    sizes = shapes(config)
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
