"""One module a model family, named by a configuration's ``family``: the
port's model (the system under test), the family's plain reference, and
the count of an epoch and a request."""
