"""Vector space, operators, stacked basis, orthogonalizers and the fused step."""
