"""Exchange plans and the exec-time B exchange."""
