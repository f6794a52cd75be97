"""Model components: layers, encoder, adapter, decoder, full model."""
