"""The plain reference that decides `correct`: the MN-QIH model of Das et
al., "Visual Dialog" (CVPR 2017), with its discriminative and generative
decoders, written in plain PyTorch and computed in float32 with TF32 off.

It imports nothing of visdial_tpu_torch and nothing of JAX.  From the run
it takes the split's arrays and the weights the benchmark made, and the
seeds; it works out again everything the program derives from them: the
batches' dialogs, right-aligned tokens, per-round facts, the candidates'
unique rows, the dropout masks (dropout.py), the option table and the
ranks.

model.py   the forward passes and losses (precision "f32", or "fp8": every
           product's operands rounded to float8 e4m3 with a per-tensor
           scale, the lower-precision control)
data.py    the batches, assembled from the split arrays
steps.py   training steps with the global-norm clip and Adam, and the
           retrieval ranks of a split
"""
