"""The LM stack's serving path: layers, attention, the MoE layer, the
Mamba2 and xLSTM blocks, the ten architectures' models, and the weights'
conversion from the reference."""
