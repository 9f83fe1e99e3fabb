"""Device engine of the port: histograms (K1), the wired layout and its row
move (K2), the split scan, the depthwise grower, the boosting loop and
predict."""
