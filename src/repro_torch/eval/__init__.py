"""Zero-shot evaluation helpers of the port."""
