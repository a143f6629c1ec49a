"""Host-side data layer: registry, tokenizer, loaders, batch pipeline."""
