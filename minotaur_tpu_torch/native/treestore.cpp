// Native node store for the branch-and-bound tree.
//
// Reference analogue: TreeManager + NodeHeap/NodeStack + Node storage
// (src/base/TreeManager.cpp, NodeHeap.cpp). The reference's node is a
// pointer-rich object; here a node is a row in contiguous (vlb, vub,
// warm_x, warm_y) slabs plus a fixed-width scalar record, so batch pops
// hand the caller dense slabs ready to ship to the device without any
// gather on the Python side.  Exposed through a C ABI for ctypes.
//
// Heap order: min by (lb, -depth) — best-bound first, deeper as
// tie-break, matching TreeSearchOrder::BEST_THEN_DIVE
// (TreeManager.cpp:36-57).
//
// Scalar record layout (SCALARS doubles per node, fixed):
//   0: nid   1: depth   2: lb   3: branch_var   4: branch_dir
//   5: branch_frac   6: vio_val   7: pred_iters   8: tb_score
//   9: has_warm_x   10: has_warm_y

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kScalars = 11;

struct HeapEntry {
  double key1;     // primary sort key
  double key2;     // tie-break
  uint64_t seq;    // FIFO tie-break for determinism
  int64_t slot;    // row in the arrays
};

struct EntryLess {
  bool operator()(const HeapEntry& a, const HeapEntry& b) const {
    // std::push_heap builds a max-heap; invert for min-heap
    if (a.key1 != b.key1) return a.key1 > b.key1;
    if (a.key2 != b.key2) return a.key2 > b.key2;
    return a.seq > b.seq;
  }
};

class TreeStore {
 public:
  TreeStore(int64_t n, int64_t m, int order)
      : n_(n), m_(m), order_(order), seq_(0) {}

  int64_t alloc_slot() {
    if (!free_.empty()) {
      int64_t s = free_.back();
      free_.pop_back();
      return s;
    }
    int64_t s = static_cast<int64_t>(scal_.size() / kScalars);
    scal_.resize((s + 1) * kScalars);
    vlb_.resize((s + 1) * n_);
    vub_.resize((s + 1) * n_);
    warmx_.resize((s + 1) * n_);
    warmy_.resize((s + 1) * m_);
    return s;
  }

  void push(const double* scal, const double* vlb, const double* vub,
            const double* warm_x, const double* warm_y) {
    int64_t s = alloc_slot();
    std::memcpy(&scal_[s * kScalars], scal, kScalars * sizeof(double));
    std::memcpy(&vlb_[s * n_], vlb, n_ * sizeof(double));
    std::memcpy(&vub_[s * n_], vub, n_ * sizeof(double));
    if (scal[9] != 0.0)
      std::memcpy(&warmx_[s * n_], warm_x, n_ * sizeof(double));
    if (scal[10] != 0.0 && m_ > 0)
      std::memcpy(&warmy_[s * m_], warm_y, m_ * sizeof(double));
    heap_.push_back(make_entry(s));
    std::push_heap(heap_.begin(), heap_.end(), EntryLess{});
  }

  void push_batch(int64_t k, const double* scal, const double* vlb,
                  const double* vub, const double* warm_x,
                  const double* warm_y) {
    for (int64_t i = 0; i < k; ++i) {
      push(scal + i * kScalars, vlb + i * n_, vub + i * n_,
           warm_x + i * n_, warm_y + i * m_);
    }
  }

  // Pops up to k nodes with lb < cutoff into caller-provided slabs.
  // Returns the number of nodes written; pruned-by-cutoff nodes are
  // freed and counted in *pruned.
  int64_t pop_batch(int64_t k, double cutoff, double* scal_out,
                    double* vlb_out, double* vub_out, double* warmx_out,
                    double* warmy_out, int64_t* pruned) {
    int64_t got = 0;
    *pruned = 0;
    while (!heap_.empty() && got < k) {
      std::pop_heap(heap_.begin(), heap_.end(), EntryLess{});
      HeapEntry e = heap_.back();
      heap_.pop_back();
      int64_t s = e.slot;
      if (scal_[s * kScalars + 2] >= cutoff) {
        free_.push_back(s);
        ++*pruned;
        continue;
      }
      std::memcpy(scal_out + got * kScalars, &scal_[s * kScalars],
                  kScalars * sizeof(double));
      std::memcpy(vlb_out + got * n_, &vlb_[s * n_], n_ * sizeof(double));
      std::memcpy(vub_out + got * n_, &vub_[s * n_], n_ * sizeof(double));
      std::memcpy(warmx_out + got * n_, &warmx_[s * n_],
                  n_ * sizeof(double));
      if (m_ > 0)
        std::memcpy(warmy_out + got * m_, &warmy_[s * m_],
                    m_ * sizeof(double));
      free_.push_back(s);
      ++got;
    }
    return got;
  }

  // Drop all open nodes with lb >= cutoff; returns count dropped.
  int64_t prune_by_cutoff(double cutoff) {
    int64_t dropped = 0;
    std::vector<HeapEntry> keep;
    keep.reserve(heap_.size());
    for (const HeapEntry& e : heap_) {
      if (scal_[e.slot * kScalars + 2] >= cutoff) {
        free_.push_back(e.slot);
        ++dropped;
      } else {
        keep.push_back(e);
      }
    }
    if (dropped) {
      heap_.swap(keep);
      std::make_heap(heap_.begin(), heap_.end(), EntryLess{});
    }
    return dropped;
  }

  double best_lb() const {
    double best = 1e300;
    for (const HeapEntry& e : heap_)
      best = std::min(best, scal_[e.slot * kScalars + 2]);
    return best;
  }

  int64_t size() const { return static_cast<int64_t>(heap_.size()); }
  int64_t n() const { return n_; }
  int64_t m() const { return m_; }

 private:
  HeapEntry make_entry(int64_t s) {
    double lb = scal_[s * kScalars + 2];
    double depth = scal_[s * kScalars + 1];
    double k1, k2;
    switch (order_) {
      case 0:  // dfs: deepest first
        k1 = -depth;
        k2 = lb;
        break;
      case 1:  // bfs: best bound, shallower first
        k1 = lb;
        k2 = depth;
        break;
      default:  // BthenD
        k1 = lb;
        k2 = -depth;
    }
    return HeapEntry{k1, k2, seq_++, s};
  }

  int64_t n_, m_;
  int order_;
  uint64_t seq_;
  std::vector<double> scal_, vlb_, vub_, warmx_, warmy_;
  std::vector<int64_t> free_;
  std::vector<HeapEntry> heap_;
};

}  // namespace

extern "C" {

int64_t treestore_scalars() { return kScalars; }

void* treestore_create(int64_t n, int64_t m, int order) {
  return new TreeStore(n, m, order);
}

void treestore_destroy(void* ts) { delete static_cast<TreeStore*>(ts); }

void treestore_push(void* ts, const double* scal, const double* vlb,
                    const double* vub, const double* warm_x,
                    const double* warm_y) {
  static_cast<TreeStore*>(ts)->push(scal, vlb, vub, warm_x, warm_y);
}

// Batch push: k nodes from dense slabs (row i = node i).
void treestore_push_batch(void* ts, int64_t k, const double* scal,
                          const double* vlb, const double* vub,
                          const double* warm_x, const double* warm_y) {
  static_cast<TreeStore*>(ts)->push_batch(k, scal, vlb, vub, warm_x,
                                          warm_y);
}

int64_t treestore_pop_batch(void* ts, int64_t k, double cutoff,
                            double* scal_out, double* vlb_out,
                            double* vub_out, double* warmx_out,
                            double* warmy_out, int64_t* pruned) {
  return static_cast<TreeStore*>(ts)->pop_batch(
      k, cutoff, scal_out, vlb_out, vub_out, warmx_out, warmy_out, pruned);
}

int64_t treestore_prune(void* ts, double cutoff) {
  return static_cast<TreeStore*>(ts)->prune_by_cutoff(cutoff);
}

double treestore_best_lb(void* ts) {
  return static_cast<TreeStore*>(ts)->best_lb();
}

int64_t treestore_size(void* ts) {
  return static_cast<TreeStore*>(ts)->size();
}

}  // extern "C"
