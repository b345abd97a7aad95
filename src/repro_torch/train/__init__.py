"""Training: AdamW and the train-step paths."""
