"""Command-line tools that check the port on the card (run with ``python -m``)."""
