"""String parsers and the activation registry."""
