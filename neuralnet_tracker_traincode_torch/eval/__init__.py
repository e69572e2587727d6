"""The eval path: the Predictor (crop, eval forward, backtransform), the
metrics, the rotation alignments and the evaluation table."""
