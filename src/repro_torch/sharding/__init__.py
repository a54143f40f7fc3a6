"""Parameter partitioning and the activation mesh for the LM on a device
mesh (``partition.Partitioner``, ``activations.activation_mesh``)."""
