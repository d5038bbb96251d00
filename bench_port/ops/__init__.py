"""Operations a traffic mix drives, one module per ``op`` of a mix."""
