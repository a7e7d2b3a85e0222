"""The dropout masks of a training step, drawn again from the step's seeds.

The seeds: the train state holds a CPU torch.Generator, seeded by the
benchmark; each step draws two 62-bit seeds from it,
`torch.randint(0, 2**62, (2,), generator=cpu)` (one for the encoder, one
for the decoder), and a rank d of a data axis adds d to both.  Each seed
starts a torch.Generator on the batch's device, from which every keep mask
is `torch.rand(shape, generator=g) < 1 - rate`, drawn in this order:

  encoder: the question LSTM's (B R, Lq, H); the fact LSTM's (B R, Lf, H);
           [query; memory]'s (B R, 2H)
  decoder: disc, the candidate LSTM's (B R K, La, H) over the batch's
           unique candidate rows in ascending pool order, then all-pad
           filler rows up to B R K (without disc_dedup_options, over every
           candidate in batch order); gen, the language model's
           (B R, La + 1, H)

The masks are the same values whatever precision the model then runs in.
"""

from __future__ import annotations

import torch


def step_seeds(cpu: torch.Generator, steps: int) -> list[tuple[int, int]]:
    return [tuple(torch.randint(0, 2 ** 62, (2,), generator=cpu).tolist())
            for _ in range(steps)]


def _keep(g: torch.Generator, shape, rate: float) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device) < 1.0 - rate


def encoder_masks(seed: int, n: int, config: dict, device) -> dict:
    H, rate = config["rnn_hidden_size"], config["dropout"]
    g = torch.Generator(device=device).manual_seed(seed)
    fact_width = max(config["max_cap_len"],
                     config["max_ques_len"] + config["max_ans_len"])
    return {"ques": _keep(g, (n, config["max_ques_len"], H), rate),
            "fact": _keep(g, (n, fact_width, H), rate),
            "cat": _keep(g, (n, 2 * H), rate)}


def decoder_mask(seed: int, rows: int, width: int, config: dict,
                 device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return _keep(g, (rows, width, config["rnn_hidden_size"]),
                 config["dropout"])
