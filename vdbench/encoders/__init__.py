"""Encoder families: all the benchmark knows of one family of the port's
encoders sits in one module, encoders/<family>.py, found by the
configuration's encoder name.

A family is the encoder name's text before its first "-", the port's own
rule ("mn-ques-im-hist" is "mn"; "lf", "hre", "hrea" likewise).  Its module
is looked up once, at set-up, beside the spec's configurations
(spec.load_cell; a test's spec brings its own), and provides:

  weight_shapes(config)                    {path: shape} of the encoder's
                                           leaves, in the order weights.make
                                           draws them (weights.lstm_shapes
                                           and linear_shapes; an LSTM's
                                           prefix ends "_lstm", whose
                                           forget-gate bias make sets)
  encoder_batch(split, idx, config)        the encoder's inputs of dialogs
                                           idx as the reference assembles
                                           them (NumPy arrays)
  encoder_masks(seed, n, config, device)   the encoder's dropout keep masks,
                                           drawn in the program's order
  encode(ops, p, b, rate, masks)           joint (B R, H) in float32
  encoder_work(config, split, idx, train)  a work.Work of the encoder's K1
                                           and K2 operations and bytes and
                                           its model operations

What every family shares stays outside: the weights' embedding and
decoders (weights.py), the LSTM and the primitives the decoders use
(reference/model.py), the step's seeds and the decoder's mask
(reference/dropout.py), the decoders' counts (work.py).  Like reference/, a
family module imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))
FUNCTIONS = ("weight_shapes", "encoder_batch", "encoder_masks", "encode",
             "encoder_work")


def load(config: dict, directory: str = HERE):
    """The family module of config's encoder, read from
    directory/<family>.py; an encoder whose family has no module, or a
    module that lacks one of FUNCTIONS, fails here, naming the file."""
    family = config["encoder"].split("-")[0]
    path = os.path.join(directory, family + ".py")
    if not os.path.isfile(path):
        raise SystemExit(f"encoder {config['encoder']!r}: no encoder family "
                         f"module {path}")
    mod_spec = importlib.util.spec_from_file_location(
        "vdbench_encoder_" + family, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    missing = [f for f in FUNCTIONS if not callable(getattr(mod, f, None))]
    if missing:
        raise SystemExit(f"encoder family module {path} lacks {missing}")
    return mod
