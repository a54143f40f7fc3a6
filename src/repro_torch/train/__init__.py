"""LM training: the loss, AdamW and Adafactor, and the train step."""
