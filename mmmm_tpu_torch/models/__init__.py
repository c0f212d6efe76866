"""Models of the port: CogVLM (``cogvlm``), SegVol SAM (``segvol``),
generation and grounded inference."""
