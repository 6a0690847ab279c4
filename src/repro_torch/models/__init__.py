"""Model definitions: config records, registry, layers and the decoder LM."""
