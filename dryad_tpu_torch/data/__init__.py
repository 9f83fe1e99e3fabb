"""Host-side data layer of the port: quantile sketch and dense binning."""
