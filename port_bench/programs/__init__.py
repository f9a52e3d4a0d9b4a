"""The system under test, one module a model family: each ``build``
makes the port's own trainer and device-resident training split for a
configuration and its traffic, through the port's public constructors."""
