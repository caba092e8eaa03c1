"""Decoder language model: config, layers, stacked-block LM, API."""
