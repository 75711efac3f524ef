"""Training of the LM and the codec on one card."""
