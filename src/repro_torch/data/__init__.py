"""The synthetic token pipeline (``pipeline``) and the golden files the
port is held to on the card (``*.npz``)."""
