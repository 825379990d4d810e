"""The port's command-line entry points (`python -m
qea_ocr_tpu_torch.cli.<name>`)."""

import dataclasses


def config_from_args(cls, args):
    """A `cls` config from parsed training flags: each field that has a
    flag of its name takes the flag's value (`--epoch` fills `epochs`;
    `--doc_size`, where given, a tuple); the others keep their defaults."""
    values = dict(vars(args), epochs=args.epoch)
    if getattr(args, "doc_size", None):
        values["doc_size"] = tuple(args.doc_size)
    else:
        values.pop("doc_size", None)
    return cls(**{f.name: values[f.name] for f in dataclasses.fields(cls)
                  if f.name in values})
