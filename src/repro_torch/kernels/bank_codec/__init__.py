"""The bank_codec family: absmax scale, encode and decode of quantized
owner-bank rows (int8 / fp8)."""
