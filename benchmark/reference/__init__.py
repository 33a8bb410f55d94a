"""Plain PyTorch reference of the benchmarked system: ``nets`` (trunks,
ROI align, heads, preprocess), ``search`` (the zoom search and NMS) and
``lowp`` (the lower-precision control). Imports nothing of the program."""
