"""SELD-TCN models (eval mode) and the fused serving path."""
