"""The ssm_scan family: the chunked SSD scan of Mamba2 (and of the mLSTM)."""
