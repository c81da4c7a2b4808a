"""Model physics as block-sparse weak forms."""
