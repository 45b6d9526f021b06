"""Device arithmetic of the torch port: elementwise field ops, exact
plane matmuls, the NTT, and the hand-written kernels behind them."""
