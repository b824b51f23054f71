"""The LM scaffold: parameter specs, layers and the decoder."""
