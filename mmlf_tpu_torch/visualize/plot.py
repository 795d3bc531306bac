"""Matplotlib fallback for the pgfplots figure builds.

The reference renders its figures with pdflatex/pgfplots from the CSVs the
analysis CLIs emit (reference: mmlf/visualize/{gmm,sparsify}/figure.tex +
Makefile).  Those TeX builds are kept verbatim in the sibling directories —
this module renders the same CSVs to PNG/SVG/PDF without a TeX toolchain:

    python -m mmlf_tpu_torch.visualize.plot sparsify.csv out.png
    python -m mmlf_tpu_torch.visualize.plot posterior_256_256.csv out.svg

The first CSV column is the x axis; every remaining column is a series.
``sparsify.csv`` (frac/oracle/uncert/sparse_err) gets the sparsification
figure's axis labels and the dashed sparsification-error line, matching the
TeX figure; anything else is treated as a per-pixel distribution curve
(disparity vs density).
"""

import sys

import click
import numpy as np

# Categorical series colors: the first slots of a CVD-validated palette in
# fixed order (identity is also carried by the legend + line style, never by
# color alone).  Grid/axes are recessive; text wears neutral ink.
SERIES = ['#2a78d6', '#eb6834', '#1baf7a', '#eda100',
          '#e87ba4', '#008300', '#4a3aa7', '#e34948']
INK = '#0b0b0b'
INK_2 = '#52514e'
GRID = '#e5e5e3'


def read_csv(path: str):
    """Header + float columns from an exporter CSV (comma + padding)."""
    with open(path) as f:
        names = [c.strip() for c in f.readline().split(',')]
    if len(names) < 2:
        # an x column plus at least one series; atleast_2d would otherwise
        # misread an x-only file as one ROW and give a confusing shape error
        raise click.ClickException(
            f'{path}: only {len(names)} column(s) — nothing to plot '
            f'(need an x column plus at least one series)')
    data = np.genfromtxt(path, delimiter=',', skip_header=1, dtype=np.float64)
    if data.ndim == 1:
        # genfromtxt flattens both single-row and single-column files;
        # the header says which one this is
        data = data.reshape(-1, len(names))
    if data.shape[1] != len(names):
        raise click.ClickException(
            f'{path}: {len(names)} header columns but {data.shape[1]} data '
            f'columns')
    return names, data


def render(names, data, out: str, title: str = ''):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    sparsify = names[:1] == ['frac'] and 'oracle' in names
    x, series = data[:, 0], list(zip(names[1:], data[:, 1:].T))
    if len(series) > len(SERIES):
        print(f'plotting the first {len(SERIES)} of {len(series)} series '
              f'(fold the rest or facet)', file=sys.stderr)
        series = series[:len(SERIES)]

    fig, ax = plt.subplots(figsize=(6.4, 4.0), dpi=150)
    fig.patch.set_facecolor('white')
    ax.set_facecolor('white')
    for i, (name, y) in enumerate(series):
        dashed = sparsify and name == 'sparse_err'
        ax.plot(x, y, color=SERIES[i], linewidth=1.8,
                linestyle='--' if dashed else '-', label=name)

    if sparsify:
        ax.set_xlabel('fraction of pixels removed', color=INK)
        ax.set_ylabel('normalized error', color=INK)
        ax.set_xlim(0.0, 1.0)
    else:
        ax.set_xlabel('disparity', color=INK)
        ax.set_ylabel('density', color=INK)
        ax.set_ylim(bottom=0.0)
    if title:
        ax.set_title(title, color=INK, fontsize=11)

    ax.grid(True, color=GRID, linewidth=0.8)
    ax.set_axisbelow(True)
    for side in ('top', 'right'):
        ax.spines[side].set_visible(False)
    for side in ('left', 'bottom'):
        ax.spines[side].set_color(INK_2)
    ax.tick_params(colors=INK_2, labelsize=9)
    if len(series) > 1:
        leg = ax.legend(frameon=False, fontsize=9,
                        loc='upper left' if sparsify else 'best')
        for t in leg.get_texts():
            t.set_color(INK)

    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)


@click.command()
@click.argument('csv', type=click.Path(exists=True))
@click.argument('out', type=click.Path())
@click.option('--title', default='', help='Optional figure title')
def main(csv, out, title):
    """Render an analysis CSV (sparsify.csv or any distribution-curve CSV
    from the gmm2csv/post2csv/nll2csv/uncert2csv exporters) to OUT
    (.png/.svg/.pdf) — the TeX-free counterpart of the pgfplots builds."""
    names, data = read_csv(csv)
    render(names, data, out, title)
    print(f'wrote {out}')


if __name__ == '__main__':
    sys.exit(main())
