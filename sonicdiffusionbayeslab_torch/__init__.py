"""PyTorch/CUDA port of sonicdiffusionbayeslab_tpu (SD-1.5 text-to-image on NVIDIA Hopper)."""
