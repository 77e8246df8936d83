"""The dp_clip_noise family: the fused DP round and the clip norm."""
