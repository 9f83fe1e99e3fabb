"""Device engine of the port: histograms (K1), the wired layout and its row
move (K2), the tile plans and the natural-order pass (K3) of the legacy
arm, the split scan, the growers (depthwise, batched leaf-wise and the
sequential slot machine), the boosting loop and predict."""
