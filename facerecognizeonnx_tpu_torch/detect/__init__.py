"""Detection: SCRFD anchor decode and fixed-K postprocess."""
