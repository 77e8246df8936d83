"""The tree_noise family: the DP-FTRL binary-counter node refresh and the
per-round noise delta of the tree mechanism."""
