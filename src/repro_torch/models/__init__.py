"""The LM stack's serving path: layers, attention, the dense, vlm and
audio models, and the weights' conversion from the reference."""
