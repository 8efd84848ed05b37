"""SeamlessM4T-medium: an encoder-decoder multimodal (audio) backbone.

[arXiv:2308.11596]  A 12-layer decoder and a 12-layer encoder, d_model
1024, 16 heads (16 kv heads) of 64, d_ff 4096, vocab 256,206.  The
mel-spectrogram and conformer feature frontend is stubbed: the caller
passes precomputed frame embeddings of shape (batch, encoder_seq, d_model);
the port runs the bidirectional transformer encoder over the frames and
the text decoder, every layer of which cross-attends to the encoder's
output (the layers GSI drives).
"""
from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    layer_pattern=("cross",),   # every decoder layer has cross-attention
    encoder_layers=12,
    encoder_seq=1024,           # precomputed audio frame embeddings
    tie_embeddings=False,
    source="arXiv:2308.11596 (SeamlessM4T)",
))
