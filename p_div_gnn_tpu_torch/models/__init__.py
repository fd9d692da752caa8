"""EncodeProcessDecode in torch.nn, with parameter names that map 1:1 onto
the flax tree."""
