"""The SPARTA paged serving engine on the card."""
