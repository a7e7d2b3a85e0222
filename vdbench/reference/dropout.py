"""The dropout masks of a training step, drawn again from the step's seeds.

The seeds: the train state holds a CPU torch.Generator, seeded by the
benchmark; each step draws two 62-bit seeds from it,
`torch.randint(0, 2**62, (2,), generator=cpu)` (one for the encoder, one
for the decoder), and a rank d of a data axis adds d to both.  Each seed
starts a torch.Generator on the batch's device, from which every keep mask
is `torch.rand(shape, generator=g) < 1 - rate`, drawn in this order:

  encoder: the family's masks, drawn by its module's encoder_masks
           (encoders/<family>.py)
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


def keep(g: torch.Generator, shape, rate: float) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device) < 1.0 - rate


def decoder_mask(seed: int, rows: int, width: int, config: dict,
                 device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return keep(g, (rows, width, config["rnn_hidden_size"]),
                config["dropout"])
