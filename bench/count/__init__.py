"""Operations and bytes of the served work, for the rooflines and the
step's share of the chip's peak."""
