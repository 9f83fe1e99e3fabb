"""Measurement tools for the card, run by hand: no training or serving
path imports them."""
