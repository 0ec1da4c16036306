"""Window layout ops, the plain attention core, and the two CUDA kernels
(window attention, fused HRNet head) with their plain versions."""
