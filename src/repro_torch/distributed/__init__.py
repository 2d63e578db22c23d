"""The distributed layer: sharding rules as DTensor placements, gradient
compression, the hierarchical gradient reduction and the GPipe schedule."""
