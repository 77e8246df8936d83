"""The flash_attention family: the forward pass of causal, windowed or
bidirectional GQA attention with an online softmax over kv tiles."""
