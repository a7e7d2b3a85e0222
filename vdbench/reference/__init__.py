"""The plain reference that decides `correct`: the VisDial models of Das et
al., "Visual Dialog" (CVPR 2017), with their discriminative and generative
decoders, written in plain PyTorch and computed in float32 with TF32 off.

It imports nothing of visdial_tpu_torch and nothing of JAX.  From the run
it takes the split's arrays and the weights the benchmark made, and the
seeds; it works out again everything the program derives from them: the
batches' dialogs, right-aligned tokens, the encoder's inputs, the
candidates' unique rows, the dropout masks, the option table and the
ranks.

What is shared by every encoder lives here; what one encoder family alone
has (its inputs, masks and forward) lives in its module,
encoders/<family>.py, which the callers hand in.

model.py   the LSTM and the primitives built on it, and both decoders'
           losses (precision "f32", or "fp8": every product's operands
           rounded to float8 e4m3 with a per-tensor scale, the
           lower-precision control)
data.py    the batches' shared parts, assembled from the split arrays: the
           epoch's order, right alignment, the image, the candidates and
           the generative targets
dropout.py the step's seeds and the decoder's keep mask
steps.py   training steps with the global-norm clip and Adam, and the
           retrieval ranks of a split
"""
