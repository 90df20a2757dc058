"""AMP op lists (parity: python/mxnet/contrib/amp/lists/symbol.py).

Three classes, mirroring the reference's FP16_FUNCS / FP32_FUNCS /
WIDEST_TYPE_CASTS (``amp.py:161-195``), retargeted at bfloat16 — the
MXU-native low-precision dtype (no loss scaling strictly required, but a
dynamic scaler is provided for float16 parity).
"""

# compute-bound ops that run in the target (low-precision) dtype —
# these are the MXU matmul/conv consumers
TARGET_DTYPE_OPS = [
    "FullyConnected",
    "Convolution",
    "Deconvolution",
    "dot",
    "batch_dot",
    "_linalg_gemm",
    "_linalg_gemm2",
    "RNN",
    "_npi_einsum",
    "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
    # flash attention: bf16 in/out is safe — the Pallas kernel upcasts
    # per-block and accumulates softmax/output in f32 internally; f32
    # inputs would double attention HBM traffic and halve MXU rate
    # (xplane r5: f32[96,512,64] custom-calls before this entry)
    "_contrib_flash_attention",
]

# numerically-sensitive ops forced to float32
FP32_OPS = [
    "softmax",
    "log_softmax",
    "softmin",
    "SoftmaxActivation",
    "SoftmaxOutput",
    "softmax_cross_entropy",
    "CTCLoss",
    "exp",
    "log",
    "log2",
    "log10",
    "log1p",
    "expm1",
    "logsumexp",
    "norm",
    "mean",
    "sum",
    "prod",
    "nansum",
    "nanprod",
    "cumsum",
    "erfinv",
    "gamma",
    "gammaln",
    "rsqrt",
    "rcbrt",
    "reciprocal",
    "_power",
    "broadcast_power",
    "_power_scalar",
    "_rpower_scalar",
    "_rdiv_scalar",
    "smooth_l1",
    "L2Normalization",
    "InstanceNorm",
    "LayerNorm",
    "GroupNorm",
    # measured r5 (tools A/B, llama bench geometry, best-of-3 windows):
    # norms IN this list run 7% faster end-to-end than bf16-in/bf16-out
    # norms (131.7k vs 122.7k tok/s) — XLA fuses the f32 norm chain into
    # the adjacent matmuls and skips a convert round trip
    "RMSNorm",
]

# multi-input ops whose inputs are cast to the widest participating dtype
WIDEST_TYPE_CASTS = [
    "elemwise_add",
    "elemwise_sub",
    "elemwise_mul",
    "elemwise_div",
    "broadcast_add",
    "broadcast_sub",
    "broadcast_mul",
    "broadcast_div",
    "broadcast_maximum",
    "broadcast_minimum",
    "broadcast_hypot",
    "_maximum",
    "_minimum",
    "_hypot",
    "concat",
    "stack",
    "where",
]
