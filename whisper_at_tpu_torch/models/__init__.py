"""Model modules of the port: dims, layers, encoder, decoder, TL-TR head."""
