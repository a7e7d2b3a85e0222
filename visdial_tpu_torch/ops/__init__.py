"""The port's operations: the plain PyTorch versions and the wrappers of the
hand-written CUDA kernels (csrc/)."""


def kernel_wrappers() -> dict:
    """The wrappers of the six hand-written kernels by name; each counts
    its launches in `.launches`."""
    from .attention_cuda import attention_fusion, masked_slot_attention
    from .lm_score_cuda import lm_dlogits, lm_token_logprobs_lse
    from .lstm_cuda import lstm_layer, lstm_layer_bwd

    return {"lstm_layer": lstm_layer, "lstm_layer_bwd": lstm_layer_bwd,
            "attention": masked_slot_attention,
            "attention_fusion": attention_fusion,
            "lm_score": lm_token_logprobs_lse, "lm_dlogits": lm_dlogits}
