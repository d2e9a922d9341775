"""Training of the port: AdamW, the train step, checkpoints and the trainer."""
