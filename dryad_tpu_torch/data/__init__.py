"""Host-side data layer of the port: quantile sketch, dense and CSR
binning, exclusive feature bundling, and out-of-core chunked ingest with
on-disk streamed datasets (``streaming``, ``stream_dataset``)."""
