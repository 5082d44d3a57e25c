"""Vision tower, projector, fusion, decoder, generation and the TEOChat shell."""
