"""Protein C-alpha backbone diffusion with motif scaffolding, in PyTorch:
geometry, the graph SDEs, the GVP denoiser, the ResDiff loss, the motif
conditioner, and the numpy-only datasets and PDB files."""
