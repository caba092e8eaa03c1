"""DiPaCo core of the port (routing so far)."""
