"""The weights bridge between the JAX package and the port.

Both sides key a parameter by its tree-path string, the format of
visdial_tpu/utils/tree.py::tree_path_str: dict keys and list indices joined
by '/', e.g. 'embed/table', 'encoder/ques_lstm/layers/0/w',
'encoder/fusion/b', 'decoder/opt_lstm/layers/1/b'.  The layouts are the JAX
package's own (packed LSTM W (in+H, 4H) for [x; h], one bias, gates
i, f, g, o), so a bridge is a rename-free copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts/lists -> {tree path: leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(flat: dict):
    """{tree path: leaf} -> nested dicts, with all-digit levels as lists."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def param_shapes(cfg: Config) -> dict[str, tuple]:
    """{tree path: shape} of the model `cfg` describes (built on the meta
    device, so no memory is touched)."""
    from ..models.model import model_init

    return {k: tuple(v.shape)
            for k, v in flatten(model_init(cfg, device="meta")).items()}


def params_from_numpy(flat: dict[str, np.ndarray], cfg: Config,
                      device) -> dict:
    """Flat numpy arrays keyed by tree path -> the port's param tree on
    `device`, float32.  Every key and shape the config implies is checked,
    with the errors of visdial_tpu/utils/checkpoint.py::_dict_to_tree."""
    tensors = {}
    for key, want in param_shapes(cfg).items():
        if key not in flat:
            raise ValueError(
                f"checkpoint is missing array '{key}' (corrupt file, or a "
                f"checkpoint whose meta.json was edited out from under its "
                f"arrays)")
        arr = np.asarray(flat[key])
        if arr.shape != want:
            raise ValueError(
                f"checkpoint array '{key}' has shape {arr.shape}, expected "
                f"{want} from the embedded config — the arrays do not match "
                f"the config stored beside them")
        tensors[key] = torch.from_numpy(
            np.array(arr, dtype=np.float32)).to(device)
    return unflatten(tensors)


def params_to_numpy(params: dict) -> dict[str, np.ndarray]:
    """The port's param tree -> flat float32 numpy arrays by tree path."""
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in flatten(params).items()}
