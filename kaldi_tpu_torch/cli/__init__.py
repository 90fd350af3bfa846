"""Command-line tools of the port (Kaldi tool names, ParseOptions)."""
